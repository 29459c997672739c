// The naive estimator's shade step (render/integrator.py, make_bounce_fn's
// shade) as one launch, for Hopper (sm_90a): everything between a bounce's
// closest hit and the next PathState, for frames that carry no gradient.
//
// Replaces no TPU kernel: the JAX package's shading is jnp arithmetic that
// XLA fuses into a few loops. Eager PyTorch dispatches each op of it, about
// 140 a call (resolve_hits' Möller–Trumbore recompute, the material gather,
// the background and emitter terms, the oriented normal, the PCG fold and
// draws, the cosine warp and its frame, throughput, roulette and the next
// state), so on the card the step is written here as the one loop XLA makes
// of it: one launch in place of ~140 host dispatches.
//
// One lane a thread, one thread a path:
//   resolve   the winning row (tri clamped to 0) of v0, e1, e2: t, point,
//             the geometric normal and, with SHADING_NORMALS, the shading
//             normal from n0, n1, n2;
//   emission  misses add throughput x background; emitter hits (HAS_EMIT)
//             add throughput x emissive x intensity and end the path;
//   scatter   the normal oriented against the ray; kb = fold(key, bounce),
//             u = the first 3 words of PCG4D(kb); diffuse hits (HAS_DIFFUSE)
//             take the cosine warp of (u0, u1) into the normal's frame and
//             throughput x albedo; a hit of another type keeps its ray and
//             throughput, as the ops route's selects leave it;
//   roulette  (ROULETTE) survival draw from fold(kb, 7919) against the new
//             throughput's max channel clipped to [0.05, 1], survivors
//             divided by it;
//   next      o, d, throughput, radiance, alive, prev_nee and prev_pdf; the
//             keys pass through unchanged (the caller keeps them).
//
// Same numbers as the ops route: the library is built with -fmad=false, and
// each float operation is the ops route's, in its order, correctly rounded
// as torch's CUDA kernels round it. What torch's kernels compute was pinned
// on the H100 (torch 2.11): a 3-term sum over the last dim is (x0 + x2) + x1
// (two threads reduce a row of 3); linalg.cross's terms are
// fma(a, b, -(c * d)) (torch's build contracts them); a division by a
// Python scalar is a product with the float reciprocal; sinf, cosf, sqrtf
// and IEEE division agree bit for bit. PCG4D's words are pcg.cuh's, which
// the sampler's kernels use too.
//
// What bounds it on the H100: bytes. A lane reads 134 B (ray 24, throughput
// and radiance 24, flags 2, row index 8, key 32, its row's vertices 36 and
// material id 8; the material table sits in L2) and writes 54 B, against a
// few hundred float and integer instructions, under the ~10 f32 operations
// the SMs issue while device memory moves a byte (132 SMs x 128 lanes at
// 1.98 GHz over 3.35 TB/s), so the least time is the bytes at 3.35 TB/s.
// Keys are read as two 16-byte vectors; no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg.cuh"

namespace {

constexpr int THREADS = 256;

// flags
constexpr int HAS_EMIT = 1;
constexpr int HAS_DIFFUSE = 2;
constexpr int SHADING_NORMALS = 4;
constexpr int ROULETTE = 8;

// BxdfType (models/materials.py)
constexpr int64_t EMITTER = 0;
constexpr int64_t DIFFUSE = 1;

constexpr uint32_t ROULETTE_STREAM = 7919;
constexpr float RAY_OFFSET = 1e-4f;       // render/integrator.py RAY_OFFSET
constexpr float TWO_PI = 6.283185307179586f;  // 2.0 * math.pi, as torch casts it
constexpr float INV_PI = 1.0f / 3.141592653589793f;  // x / math.pi: x * (1 / float(pi))

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int64_t row, int64_t stride) {
  const float* q = p + row * stride;
  return {q[0], q[1], q[2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, int64_t row, V3 v) {
  float* q = p + 3 * row;
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
}

// torch.maximum / torch.minimum on CUDA: NaN from either side wins.
__device__ __forceinline__ float tmax(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
__device__ __forceinline__ float tmin(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }

// (a * b).sum(dim=-1): the products, then (p0 + p2) + p1.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float p0 = a.x * b.x, p1 = a.y * b.y, p2 = a.z * b.z;
  return (p0 + p2) + p1;
}

// torch.linalg.cross(a, b).
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)), __fmaf_rn(a.x, b.y, -(a.y * b.x))};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }

// ops/intersect.py _safe_normalize: x / sqrt(max(sum(x * x), 1e-24)).
__device__ __forceinline__ V3 safe_normalize(V3 x) {
  const float r = sqrtf(tmax(dot(x, x), 1e-24f));
  return {x.x / r, x.y / r, x.z / r};
}

__global__ void __launch_bounds__(THREADS) shade_naive_kernel(
    const float* __restrict__ o_in, int64_t o_stride, const float* __restrict__ d_in,
    const float* __restrict__ tp_in, const float* __restrict__ rad_in, const bool* __restrict__ alive_in,
    const int64_t* __restrict__ tri_in, const bool* __restrict__ hit_in, const ulonglong2* __restrict__ keys,
    const float* __restrict__ v0s, const float* __restrict__ e1s, const float* __restrict__ e2s,
    const float* __restrict__ n0s, const float* __restrict__ n1s, const float* __restrict__ n2s,
    const int64_t* __restrict__ mat_id, const int64_t* __restrict__ mat_type, const float* __restrict__ albedos,
    const float* __restrict__ emissives, const float* __restrict__ intensities, float* __restrict__ o_out,
    float* __restrict__ d_out, float* __restrict__ tp_out, float* __restrict__ rad_out,
    bool* __restrict__ alive_out, bool* __restrict__ prev_nee_out, float* __restrict__ prev_pdf_out, int64_t r,
    V3 background, uint32_t bounce, int flags) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= r) return;
  const V3 o = load3(o_in, i, o_stride);
  const V3 d = load3(d_in, i, 3);
  const V3 tp = load3(tp_in, i, 3);
  V3 rad = load3(rad_in, i, 3);
  const bool alive = alive_in[i];
  const bool hit = hit_in[i];
  const int64_t tri = tri_in[i];
  const int64_t row = tri < 0 ? 0 : tri;

  // resolve_hits
  const V3 v0 = load3(v0s, row, 3), e1 = load3(e1s, row, 3), e2 = load3(e2s, row, 3);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  const V3 tvec = sub(o, v0);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv_det;
  const float t = tmin(tmax(dot(e2, qvec) * inv_det, -1e8f), 1e8f);
  const V3 point = add(o, scale(t, d));
  V3 n;
  if (flags & SHADING_NORMALS) {
    const float w = (1.0f - u) - v;
    n = safe_normalize(add(add(scale(w, load3(n0s, row, 3)), scale(u, load3(n1s, row, 3))),
                           scale(v, load3(n2s, row, 3))));
  } else {
    n = safe_normalize(cross(e1, e2));
  }

  const bool found = alive && hit;
  const bool missed = alive && !hit;
  const V3 zero = {0.0f, 0.0f, 0.0f};
  rad = add(rad, pick(missed, mul(tp, background), zero));

  const int64_t m = mat_id[row];
  const int64_t type = mat_type[m];
  const bool is_emit = (flags & HAS_EMIT) && type == EMITTER;
  const bool is_diffuse = (flags & HAS_DIFFUSE) && type == DIFFUSE;
  if (flags & HAS_EMIT) {
    const V3 le = scale(intensities[m], load3(emissives, m, 3));
    rad = add(rad, pick(found && is_emit, mul(tp, le), zero));
  }

  // The normal against the incident ray: n * where(-sign(d.n) == 0, 1, -sign(d.n)).
  const float dn = dot(d, n);
  const float facing = -static_cast<float>((0.0f < dn) - (dn < 0.0f));
  const V3 n_shade = scale(facing == 0.0f ? 1.0f : facing, n);

  const ulonglong2 k0 = keys[2 * i];
  const ulonglong2 k1 = keys[2 * i + 1];
  const uint32_t stream = firefly_pcg::fold_stream(static_cast<uint32_t>(k1.y), bounce);
  const firefly_pcg::Words draw = firefly_pcg::pcg4d(
      {static_cast<uint32_t>(k0.x), static_cast<uint32_t>(k0.y), static_cast<uint32_t>(k1.x), stream});
  const float u0 = firefly_pcg::unit(draw.x), u1 = firefly_pcg::unit(draw.y);

  V3 new_d = d;
  V3 tp_factor = {1.0f, 1.0f, 1.0f};
  if (flags & HAS_DIFFUSE) {
    // cosine_sample_hemisphere(u0, u1), then local_to_world(local, n_shade).
    const float rr = sqrtf(u0);
    const float theta = TWO_PI * u1;
    const V3 local = {rr * cosf(theta), rr * sinf(theta), sqrtf(tmax(1.0f - u0, 0.0f))};
    const float sign = n_shade.z >= 0.0f ? 1.0f : -1.0f;
    const float a = -(1.0f / (sign + n_shade.z));
    const float b = (n_shade.x * n_shade.y) * a;
    const V3 tb = {1.0f + ((sign * n_shade.x) * n_shade.x) * a, sign * b, (-sign) * n_shade.x};
    const V3 bb = {b, sign + (n_shade.y * n_shade.y) * a, -n_shade.y};
    const V3 world = add(add(scale(local.x, tb), scale(local.y, bb)), scale(local.z, n_shade));
    new_d = pick(is_diffuse, world, d);
    tp_factor = pick(is_diffuse, load3(albedos, m, 3), tp_factor);
  }

  const bool scatter = found && !is_emit;
  V3 new_tp = pick(scatter, mul(tp, tp_factor), tp);
  bool alive_next = scatter;
  if (flags & ROULETTE) {
    const float p = tmin(tmax(tmax(tmax(new_tp.x, new_tp.y), new_tp.z), 0.05f), 1.0f);
    const firefly_pcg::Words rw = firefly_pcg::pcg4d({static_cast<uint32_t>(k0.x), static_cast<uint32_t>(k0.y),
                                                      static_cast<uint32_t>(k1.x),
                                                      firefly_pcg::fold_stream(stream, ROULETTE_STREAM)});
    const bool survive = firefly_pcg::unit(rw.x) < p;
    new_tp = pick(survive, V3{new_tp.x / p, new_tp.y / p, new_tp.z / p}, new_tp);
    alive_next = alive_next && survive;
  }

  const bool prev_nee = scatter && is_diffuse;
  const float cos_scatter = tmax(dot(new_d, n_shade), 0.0f);
  store3(o_out, i, pick(scatter, add(point, scale(RAY_OFFSET, n_shade)), o));
  store3(d_out, i, pick(scatter, new_d, d));
  store3(tp_out, i, new_tp);
  store3(rad_out, i, rad);
  alive_out[i] = alive_next;
  prev_nee_out[i] = prev_nee;
  prev_pdf_out[i] = prev_nee ? cos_scatter * INV_PI : 0.0f;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, one lane a thread, and returns
// cudaGetLastError() (0 = launched). The caller checks devices, types,
// shapes, contiguity (o may have row stride 0 or 3), r >= 1 and the 16-byte
// alignment of the keys; every output is a fresh allocation. n0, n1, n2 are
// read only with SHADING_NORMALS and may be null otherwise.
int shade_naive_launch(const void* o, long long o_stride, const void* d, const void* throughput,
                       const void* radiance, const void* alive, const void* tri, const void* hit, const void* keys,
                       const void* v0, const void* e1, const void* e2, const void* n0, const void* n1,
                       const void* n2, const void* mat_id, const void* mat_type, const void* albedo,
                       const void* emissive, const void* intensity, void* o_out, void* d_out, void* tp_out,
                       void* rad_out, void* alive_out, void* prev_nee_out, void* prev_pdf_out, long long r,
                       float bg_r, float bg_g, float bg_b, unsigned int bounce, int flags, void* stream) {
  const unsigned int blocks = static_cast<unsigned int>((r + THREADS - 1) / THREADS);
  shade_naive_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), o_stride, static_cast<const float*>(d), static_cast<const float*>(throughput),
      static_cast<const float*>(radiance), static_cast<const bool*>(alive), static_cast<const int64_t*>(tri),
      static_cast<const bool*>(hit), static_cast<const ulonglong2*>(keys), static_cast<const float*>(v0),
      static_cast<const float*>(e1), static_cast<const float*>(e2), static_cast<const float*>(n0),
      static_cast<const float*>(n1), static_cast<const float*>(n2), static_cast<const int64_t*>(mat_id),
      static_cast<const int64_t*>(mat_type), static_cast<const float*>(albedo), static_cast<const float*>(emissive),
      static_cast<const float*>(intensity), static_cast<float*>(o_out), static_cast<float*>(d_out),
      static_cast<float*>(tp_out), static_cast<float*>(rad_out), static_cast<bool*>(alive_out),
      static_cast<bool*>(prev_nee_out), static_cast<float*>(prev_pdf_out), r, V3{bg_r, bg_g, bg_b}, bounce, flags);
  return static_cast<int>(cudaGetLastError());
}

const char* shade_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
