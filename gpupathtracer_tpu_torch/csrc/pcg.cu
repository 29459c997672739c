// The PCG4D path sampler's three calls (ops/sampling.py, PcgSampler), one
// launch each, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's PCG4D (gpupathtracer_tpu/ops/
// sampling.py, `pcg4d`, `PcgSampler`) is jnp arithmetic that XLA fuses into
// one loop. Eager PyTorch has no uint32 arithmetic and dispatches each int64
// op of the emulation (about 100 for one draw), so on the card the draws are
// written here as the one loop XLA makes of them.
//
// Layout, as the plain version's: a key is four uint32 words (seed, pixel,
// sample, stream) held in int64 with values in [0, 2^32), a row of 32 bytes
// of an (R, 4) int64 tensor. All arithmetic is on uint32_t and wraps mod
// 2^32, which is what the plain version's masked int64 arithmetic computes,
// so the words are the same bit for bit; (word >> 8) to float times 2^-24 is
// exact, so the draws are too. The word functions are pcg.cuh's, which the
// fused shade step (shade.cu) includes too.
//   pcg_path_keys   pixel int64 (R) -> keys (R, 4): (seed, pixel & M32, sample, 0)
//   pcg_fold        keys (R, 4) -> keys (R, 4): words 0-2 copied, word 3 =
//                   word3 * 0x9E3779B9 + c
//   pcg_uniform     keys (R, 4) -> out float (R, n), n in 1..4: the first n
//                   words of one PCG4D evaluation, (w >> 8) * 2^-24
//
// What bounds it on the H100: bytes. A lane costs at most ~50 integer and
// float instructions against 40 (keys), 64 (fold) or 32 + 4n (uniform) bytes
// of device memory, about one a byte, under the ~5 int32 operations a byte
// the SMs issue while memory moves one (132 SMs x 64 a clock at 1.98 GHz
// over 3.35 TB/s), so the least time is the bytes at 3.35 TB/s (times in
// PERF.md section 6). The
// design moves each byte once: one lane a thread, a key read as two 16-byte
// vectors and written the same way (a warp's two loads cover the same 32-byte
// sectors, so each comes from device memory once), no shared memory, and
// outputs as wide as the row allows (float4 for n = 4, float2 for n = 2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg.cuh"

namespace {

using firefly_pcg::fold_stream;
using firefly_pcg::pcg4d;
using firefly_pcg::unit;
using firefly_pcg::Words;

constexpr int THREADS = 256;

__device__ __forceinline__ int64_t lane() {
  return static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
}

__global__ void __launch_bounds__(THREADS)
    pcg_path_keys_kernel(const int64_t* __restrict__ pixel, ulonglong2* __restrict__ keys, int64_t r, uint32_t seed,
                         uint32_t sample) {
  const int64_t i = lane();
  if (i >= r) return;
  const unsigned long long p = static_cast<unsigned long long>(pixel[i]) & 0xFFFFFFFFull;
  keys[2 * i] = make_ulonglong2(seed, p);
  keys[2 * i + 1] = make_ulonglong2(sample, 0ull);
}

__global__ void __launch_bounds__(THREADS)
    pcg_fold_kernel(const ulonglong2* __restrict__ in, ulonglong2* __restrict__ out, int64_t r, uint32_t c) {
  const int64_t i = lane();
  if (i >= r) return;
  const ulonglong2 a = in[2 * i];
  ulonglong2 b = in[2 * i + 1];
  b.y = fold_stream(static_cast<uint32_t>(b.y), c);
  out[2 * i] = a;
  out[2 * i + 1] = b;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
    pcg_uniform_kernel(const ulonglong2* __restrict__ keys, float* __restrict__ out, int64_t r) {
  const int64_t i = lane();
  if (i >= r) return;
  const ulonglong2 a = keys[2 * i];
  const ulonglong2 b = keys[2 * i + 1];
  const Words v = pcg4d(Words{static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y), static_cast<uint32_t>(b.x),
                               static_cast<uint32_t>(b.y)});
  if constexpr (N == 4) {
    reinterpret_cast<float4*>(out)[i] = make_float4(unit(v.x), unit(v.y), unit(v.z), unit(v.w));
  } else if constexpr (N == 2) {
    reinterpret_cast<float2*>(out)[i] = make_float2(unit(v.x), unit(v.y));
  } else {
    float* row = out + N * i;
    row[0] = unit(v.x);
    if constexpr (N == 3) {
      row[1] = unit(v.y);
      row[2] = unit(v.z);
    }
  }
}

unsigned int blocks(int64_t r) { return static_cast<unsigned int>((r + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// Each launches its kernel on `stream`, one lane a thread, and returns
// cudaGetLastError() (0 = launched). The caller checks devices, types,
// shapes, contiguity, r >= 1 and the 16-byte alignment of the keys it
// passes in; every output is a fresh allocation, which is aligned.
int pcg_path_keys_launch(const void* pixel, void* keys, long long r, unsigned int seed, unsigned int sample,
                         void* stream) {
  pcg_path_keys_kernel<<<blocks(r), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(pixel), static_cast<ulonglong2*>(keys), r, seed, sample);
  return static_cast<int>(cudaGetLastError());
}

int pcg_fold_launch(const void* in, void* out, long long r, unsigned int c, void* stream) {
  pcg_fold_kernel<<<blocks(r), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(in), static_cast<ulonglong2*>(out), r, c);
  return static_cast<int>(cudaGetLastError());
}

// n outside 1..4 returns cudaErrorInvalidValue and launches nothing.
int pcg_uniform_launch(const void* keys, void* out, long long r, int n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const ulonglong2*>(keys);
  const auto o = static_cast<float*>(out);
  switch (n) {
    case 1: pcg_uniform_kernel<1><<<blocks(r), THREADS, 0, s>>>(k, o, r); break;
    case 2: pcg_uniform_kernel<2><<<blocks(r), THREADS, 0, s>>>(k, o, r); break;
    case 3: pcg_uniform_kernel<3><<<blocks(r), THREADS, 0, s>>>(k, o, r); break;
    case 4: pcg_uniform_kernel<4><<<blocks(r), THREADS, 0, s>>>(k, o, r); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pcg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
