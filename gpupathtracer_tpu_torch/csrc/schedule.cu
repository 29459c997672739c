// A packed search's schedule (ops/packed_intersect.py, prepare) as one
// launch, for Hopper (sm_90a): the ray features of pack_rays with the rays
// padded to whole tiles, each tile's interval-frustum cull of the blocks
// (tile_block_mask), and the front-to-back block order (plan_block_order)
// or, on the streamed route, the cluster order with each block's entry
// bound (cluster_schedule).
//
// Replaces no TPU kernel: the JAX package's schedule is jnp arithmetic that
// XLA fuses into a few loops. Eager PyTorch dispatches each op of it, about
// 70 a search, and materialises (ray tiles x blocks x 3) floats between
// them (~154 MB an op for a config 6 camera search), so on the card the
// schedule is written here as one pass over each tile: one launch in place
// of the torch ops.
//
// One CTA a ray tile, THREADS threads:
//   rays     one lane a thread: its lane value (the closest hit's alive as
//            int32, or the any hit's cutoff) and, for a ray count that needs
//            padding, the padded o and d (padded lanes: lane value 0, o = 0,
//            d = 1); then one float4 of features [d, o x d, o, 1, 0...] a
//            thread, so that a warp writes contiguous bytes (zeros on padded
//            lanes);
//   frustum  the min and max of the live lanes' origins and directions (a
//            live lane: alive, or cutoff > 0; padded lanes are dead); a
//            tile with no live lane culls every block;
//   cull     one block a thread: its slab entry and exit bounds and the
//            box-to-box distance, as tile_block_mask computes them; its
//            entry bound, or +inf where culled, goes to enter_blk (streamed
//            route) and, by a shared atomic min, into its key: the block's
//            own (resident route) or its cluster of bpc blocks' (streamed);
//   sort     the tile's keys by (key, index) (a bitonic sort of unique
//            pairs, so the order is torch's stable one), in shared memory
//            up to SHARED_KEYS keys a tile and in the caller's global
//            scratch beyond; order takes the index, or the key count where
//            the key is +inf, and enter_sorted the key.
//
// Same numbers as the torch ops, bit for bit. Every product, sum and
// quotient is a correctly rounded intrinsic (no multiply-add is fused but
// linalg.cross's, which torch's build fuses as fma(a, b, -(c * d))); a sum
// of three is (x0 + x2) + x1, as torch's CUDA reduction adds a row of 3;
// sqrt is correctly rounded. Where the slab divisors of an axis straddle 0
// the torch ops give (-inf, inf) whatever the quotients, so no quotient is
// formed there (and the x == 0 -> 1e-30 substitution, which only a
// straddling axis meets, never applies). Elsewhere both divisors have one
// sign, and a correctly rounded quotient is monotone in each operand, so the
// least and the greatest of the four quotients are two known ones, computed
// alone. A block whose numbers meet a NaN is culled by the torch ops (every
// comparison with the NaN fails, and the NaN reaches the entry bound or the
// exit bound), so its bound is never read: it is culled here too. A block
// that survives has an entry bound of at least +0 (the distance is a square
// root of squares and max(-0, +0) is +0), so the keys are never NaN or -0,
// and the order of a float compare is the order of their bits. The keys
// torch sorts with a stable sort; here the (key, index) pairs are unique,
// so any correct sort gives the same order.
//
// What bounds it on the H100: bytes, mostly the writes: 64 B of features and
// 4 B of lane value a ray, 8 B a key, and on the streamed route 4 B a
// (tile, block) pair of enter_blk (51 MB for a config 6 camera search); the
// cull costs at most six IEEE quotients and ~80 other instructions a pair.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// The most keys a tile sorts in shared memory (ops/schedule.py's
// SHARED_KEYS): 24 KB at 12 B a key. Every pack of the benchmark's cells
// fits; a tile of more keys sorts in global scratch, the same code.
constexpr int SHARED_KEYS = 2048;

// The lane input's kinds (packed_intersect's LANE_KINDS): every lane live;
// the closest hit's alive as bool or int32; the any hit's cutoffs.
constexpr int LANES_ALL = 0;
constexpr int LANES_BOOL = 1;
constexpr int LANES_INT = 2;
constexpr int LANES_CUTOFF = 3;

struct V3 {
  float x, y, z;
};

// torch.clamp(x, min=0.0): NaN stays.
__device__ __forceinline__ float clamp0(float x) { return x != x ? x : fmaxf(x, 0.0f); }

// torch.linalg.cross(a, b), as torch's CUDA build computes it.
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -__fmul_rn(a.z, b.y)), __fmaf_rn(a.z, b.x, -__fmul_rn(a.x, b.z)),
          __fmaf_rn(a.x, b.y, -__fmul_rn(a.y, b.x))};
}

// The float's bits in an order-preserving unsigned form; NaN above +inf.
__device__ __forceinline__ uint32_t ordered(float x) {
  if (x != x) return 0xFFFFFFFFu;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of ordered bits (not NaN's).
__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, s));
  return v;
}

// One axis of tile_block_mask's slab interval: [n_lo, n_hi] / [d_lo, d_hi]
// as _interval_div gives it, for an axis whose divisors do not straddle 0
// (both > 0 or both < 0) and numbers that are not NaN (n_lo <= n_hi).
__device__ __forceinline__ void slab(float nlo, float nhi, float dlo, float dhi, float& lo, float& hi) {
  if (dlo > 0.0f) {
    lo = __fdiv_rn(nlo, nlo < 0.0f ? dlo : dhi);
    hi = __fdiv_rn(nhi, nhi < 0.0f ? dhi : dlo);
  } else {
    lo = __fdiv_rn(nhi, nhi < 0.0f ? dlo : dhi);
    hi = __fdiv_rn(nlo, nlo < 0.0f ? dhi : dlo);
  }
}

struct Frustum {
  float o_lo[3], o_hi[3], d_lo[3], d_hi[3];
  bool straddles[3];
};

// The entry bound of any ray of the tile into block b's box, or +inf where
// tile_block_mask culls the block (a live block only; the caller culls dead
// blocks).
__device__ __forceinline__ float block_entry(const Frustum& f, const float* __restrict__ box_lo,
                                             const float* __restrict__ box_hi, int64_t b) {
  float enter = 0.0f, exit_ = INFINITY, sq[3];
  bool nan = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float nlo = __fsub_rn(box_lo[3 * b + a], f.o_hi[a]);
    const float nhi = __fsub_rn(box_hi[3 * b + a], f.o_lo[a]);
    nan |= (nlo != nlo) || (nhi != nhi);
    float t_lo = -INFINITY, t_hi = INFINITY;
    if (!f.straddles[a]) slab(nlo, nhi, f.d_lo[a], f.d_hi[a], t_lo, t_hi);
    nan |= (t_lo != t_lo) || (t_hi != t_hi);
    // (the order of the amax and the amin is free: no NaN reaches them here)
    enter = fmaxf(enter, clamp0(t_lo));
    exit_ = fminf(exit_, t_hi);
    const float gap = clamp0(fmaxf(nlo, -nhi));
    sq[a] = __fmul_rn(gap, gap);
  }
  const float dist = __fsqrt_rn(__fadd_rn(__fadd_rn(sq[0], sq[2]), sq[1]));
  enter = fmaxf(enter, dist);
  return (!nan && enter <= exit_) ? enter : INFINITY;
}

__global__ void __launch_bounds__(THREADS) tile_schedule_kernel(
    const float* __restrict__ o, int64_t o_stride, const float* __restrict__ d, const void* __restrict__ lanes,
    int lane_kind, const float* __restrict__ box_lo, const float* __restrict__ box_hi,
    const bool* __restrict__ block_live, int32_t* __restrict__ order, float* __restrict__ enter_sorted,
    float* __restrict__ enter_blk, float4* __restrict__ feats, void* __restrict__ lanes_out,
    float* __restrict__ o_pad, float* __restrict__ d_pad, unsigned long long* scratch, int64_t r,
    int ray_tile, int nb, int bpc, int nkeys, int sort_n) {
  extern __shared__ unsigned long long smem[];
  const int64_t tile = blockIdx.x;
  // sort_n (key bits, index) pairs, and nkeys keys' ordered bits by index:
  // in shared memory, or in this tile's part of the global scratch.
  unsigned long long* pairs = scratch ? scratch + tile * sort_n : smem;
  uint32_t* keys = scratch ? reinterpret_cast<uint32_t*>(scratch + static_cast<int64_t>(gridDim.x) * sort_n) +
                                 tile * nkeys
                           : reinterpret_cast<uint32_t*>(smem + sort_n);
  __shared__ float partial[WARPS][12];
  __shared__ Frustum frustum;

  const int64_t base = tile * ray_tile;
  for (int c = threadIdx.x; c < nkeys; c += THREADS) keys[c] = ordered(INFINITY);

  // The lanes, one a thread: lane values, padded rays, the live lanes' extent.
  // The extent is taken without NaN (fminf, fmaxf) and a NaN flagged apart:
  // a NaN in a live lane's ray culls the whole tile.
  float ext[12];  // o_lo, d_lo (min), o_hi, d_hi (max)
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    ext[k] = INFINITY;
    ext[k + 6] = -INFINITY;
  }
  bool any_live = false, any_nan = false;
  for (int i = threadIdx.x; i < ray_tile; i += THREADS) {
    const int64_t g = base + i;
    if (g < r) {
      const float* oi = o + g * o_stride;
      const float v[6] = {oi[0], oi[1], oi[2], d[3 * g], d[3 * g + 1], d[3 * g + 2]};
      bool live = true;
      if (lane_kind == LANES_BOOL) {
        const bool x = static_cast<const bool*>(lanes)[g];
        live = x;
        if (lanes_out) static_cast<int32_t*>(lanes_out)[g] = x ? 1 : 0;
      } else if (lane_kind == LANES_INT) {
        const int32_t x = static_cast<const int32_t*>(lanes)[g];
        live = x > 0;
        if (lanes_out) static_cast<int32_t*>(lanes_out)[g] = x;
      } else if (lane_kind == LANES_CUTOFF) {
        const float x = static_cast<const float*>(lanes)[g];
        live = x > 0.0f;
        if (lanes_out) static_cast<float*>(lanes_out)[g] = x;
      } else if (lanes_out) {
        static_cast<int32_t*>(lanes_out)[g] = 1;
      }
      if (o_pad) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          o_pad[3 * g + k] = v[k];
          d_pad[3 * g + k] = v[k + 3];
        }
      }
      if (live) {
        any_live = true;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          any_nan |= isnan(v[k]);
          ext[k] = fminf(ext[k], v[k]);
          ext[k + 6] = fmaxf(ext[k + 6], v[k]);
        }
      }
    } else {
      if (lanes_out) {
        if (lane_kind == LANES_CUTOFF) {
          static_cast<float*>(lanes_out)[g] = 0.0f;
        } else {
          static_cast<int32_t*>(lanes_out)[g] = 0;
        }
      }
      if (o_pad) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          o_pad[3 * g + k] = 0.0f;
          d_pad[3 * g + k] = 1.0f;
        }
      }
    }
  }

  // The features, a float4 a thread, so that a warp writes 512 contiguous
  // bytes: [d, m.x], [m.y, m.z, o.x, o.y], [o.z, 1, 0, 0], [0, 0, 0, 0] with
  // m = o x d; zeros on padded lanes.
  if (feats) {
    for (int s = threadIdx.x; s < 4 * ray_tile; s += THREADS) {
      const int64_t g = base + (s >> 2);
      const int part = s & 3;
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g < r && part < 3) {
        const float* oi = o + g * o_stride;
        const V3 ov{oi[0], oi[1], oi[2]};
        if (part == 2) {
          f = make_float4(ov.z, 1.0f, 0.0f, 0.0f);
        } else {
          const V3 dv{d[3 * g], d[3 * g + 1], d[3 * g + 2]};
          const V3 m = cross(ov, dv);
          f = part == 0 ? make_float4(dv.x, dv.y, dv.z, m.x) : make_float4(m.y, m.z, ov.x, ov.y);
        }
      }
      feats[4 * base + s] = f;
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    ext[k] = warp_min(ext[k]);
    ext[k + 6] = warp_max(ext[k + 6]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) partial[warp][k] = ext[k];
  }
  const bool tile_live = __syncthreads_or(any_live);
  const bool tile_nan = __syncthreads_or(any_nan);
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float e[4];  // o_lo, d_lo, o_hi, d_hi of axis a
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      e[q] = partial[0][3 * q + a];
      for (int w = 1; w < WARPS; ++w) {
        e[q] = q < 2 ? fminf(e[q], partial[w][3 * q + a]) : fmaxf(e[q], partial[w][3 * q + a]);
      }
    }
    frustum.o_lo[a] = e[0];
    frustum.d_lo[a] = e[1];
    frustum.o_hi[a] = e[2];
    frustum.d_hi[a] = e[3];
    frustum.straddles[a] = e[1] <= 0.0f && e[3] >= 0.0f;
  }
  __syncthreads();
  const Frustum f = frustum;
  // A tile with no live lane culls every block, as does a NaN in the
  // frustum, which reaches every block's numbers in the torch ops.
  const bool cull_all = !tile_live || tile_nan;

  // The blocks, one a thread, so that enter_blk is written contiguously;
  // a key is the least bound of its blocks (an atomic min on the ordered
  // bits: the bounds are never NaN).
  for (int b = threadIdx.x; b < nb; b += THREADS) {
    const float e = (!cull_all && block_live[b]) ? block_entry(f, box_lo, box_hi, b) : INFINITY;
    if (enter_blk) enter_blk[tile * nb + b] = e;
    if (e != INFINITY) atomicMin(&keys[bpc == 1 ? b : b / bpc], ordered(e));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < sort_n; c += THREADS) {
    pairs[c] = c < nkeys ? (static_cast<unsigned long long>(keys[c]) << 32) | static_cast<unsigned int>(c) : ~0ull;
  }
  __syncthreads();

  for (int k = 2; k <= sort_n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < sort_n; i += THREADS) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = pairs[i], b = pairs[l];
          if ((a > b) == ((i & k) == 0)) {
            pairs[i] = b;
            pairs[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int p = threadIdx.x; p < nkeys; p += THREADS) {
    const unsigned long long pair = pairs[p];
    const float key = unordered(static_cast<uint32_t>(pair >> 32));
    const int idx = static_cast<int>(pair & 0xFFFFFFFFu);
    enter_sorted[tile * nkeys + p] = key;
    order[tile * nkeys + p] = isfinite(key) ? idx : nkeys;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one CTA a tile of ray_tile lanes, and
// returns cudaGetLastError() (0 = launched). The rays are r lanes of o (row
// stride 0 or 3) and d (contiguous) and the lane input of lane_kind (null
// for every lane live), padded to rt tiles. The blocks are nb boxes and
// live flags, in clusters of bpc (bpc = 1 and a null enter_blk on the
// resident route). order and enter_sorted are (rt, nb / bpc), enter_blk
// (rt, nb); feats and lanes_out may be null (a schedule alone), o_pad and
// d_pad are null unless the rays need padding. scratch is null for at most
// SHARED_KEYS keys a tile, else rt * (8 * sort_n + 4 * nb / bpc) bytes,
// sort_n the least power of two >= nb / bpc. The caller checks devices,
// types, shapes, contiguity and rt >= 1; every output is a fresh
// allocation, which is aligned. Keys past SHARED_KEYS with no scratch
// return cudaErrorInvalidValue and launch nothing.
int tile_schedule_launch(const void* o, long long o_stride, const void* d, const void* lanes, int lane_kind,
                         const void* box_lo, const void* box_hi, const void* block_live, void* order,
                         void* enter_sorted, void* enter_blk, void* feats, void* lanes_out, void* o_pad,
                         void* d_pad, void* scratch, long long r, int rt, int ray_tile, int nb, int bpc,
                         void* stream) {
  const int nkeys = nb / bpc;
  if (nkeys < 1 || nb % bpc || (nkeys > SHARED_KEYS && !scratch)) return static_cast<int>(cudaErrorInvalidValue);
  int sort_n = 1;
  while (sort_n < nkeys) sort_n <<= 1;
  const size_t shared =
      scratch ? 0 : static_cast<size_t>(sort_n) * sizeof(unsigned long long) + sizeof(uint32_t) * nkeys;
  tile_schedule_kernel<<<rt, THREADS, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), o_stride, static_cast<const float*>(d), lanes, lane_kind,
      static_cast<const float*>(box_lo), static_cast<const float*>(box_hi), static_cast<const bool*>(block_live),
      static_cast<int32_t*>(order), static_cast<float*>(enter_sorted), static_cast<float*>(enter_blk),
      static_cast<float4*>(feats), lanes_out, static_cast<float*>(o_pad), static_cast<float*>(d_pad),
      static_cast<unsigned long long*>(scratch), r, ray_tile, nb, bpc, nkeys, sort_n);
  return static_cast<int>(cudaGetLastError());
}

const char* schedule_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
