// The PCG4D path sampler's uint32 word functions, the one definition that
// the sampler's own kernels (pcg.cu) and the fused shade step (shade.cu)
// both include.
//
// A key is four uint32 words (seed, pixel, sample, stream). Every function
// is plain uint32_t arithmetic that wraps mod 2^32, which is what the plain
// int64 version of ops/sampling.py computes with its masks, so the words
// agree bit for bit; (word >> 8) to float times 2^-24 is exact, so the draws
// do too. Outside nvcc the functions are plain inline C++, so a host
// compiler can build them as well.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FIREFLY_PCG_FN __host__ __device__ __forceinline__
#else
#define FIREFLY_PCG_FN inline
#endif

namespace firefly_pcg {

constexpr uint32_t GOLDEN = 0x9E3779B9u;  // the fold's odd multiplier

struct Words {
  uint32_t x, y, z, w;
};

// PCG4D mixing function over one key's four words.
FIREFLY_PCG_FN Words pcg4d(Words v) {
  v.x = v.x * 1664525u + 1013904223u;
  v.y = v.y * 1664525u + 1013904223u;
  v.z = v.z * 1664525u + 1013904223u;
  v.w = v.w * 1664525u + 1013904223u;
  v.x += v.y * v.w;
  v.y += v.z * v.x;
  v.z += v.x * v.y;
  v.w += v.y * v.z;
  v.x ^= v.x >> 16;
  v.y ^= v.y >> 16;
  v.z ^= v.z >> 16;
  v.w ^= v.w >> 16;
  v.x += v.y * v.w;
  v.y += v.z * v.x;
  v.z += v.x * v.y;
  v.w += v.y * v.z;
  return v;
}

// The stream word of fold(key, c); the other three words are unchanged.
FIREFLY_PCG_FN uint32_t fold_stream(uint32_t stream, uint32_t c) { return stream * GOLDEN + c; }

// A draw's float in [0, 1): the word's top 24 bits times 2^-24, exact.
FIREFLY_PCG_FN float unit(uint32_t w) { return static_cast<float>(w >> 8) * 0x1p-24f; }

}  // namespace firefly_pcg
