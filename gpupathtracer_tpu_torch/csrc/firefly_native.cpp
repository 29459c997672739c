// firefly_native: the host (C++) builders of gpupathtracer_tpu_torch.
//
// A copy of the JAX package's native/firefly_native.cpp, so that the port
// neither reads nor builds anything outside its own package. Three C entry
// points: a fast OBJ parser producing SoA triangle arrays, a BVH builder
// emitting the flattened threaded layout of accel/bvh.py (same median
// split, DFS order and escape links), and the edge-table builder of
// grad/edges.py (same quantization and first-encounter order). Each gives
// the Python builder's arrays exactly (tests/test_torch_native.py).
//
// C ABI only, loaded with ctypes. ops/_build.py compiles it at first use
// with the host C++ compiler (-O3 -ffp-contract=off).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>
#include <unordered_map>
#include <cmath>

namespace {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

struct Corner {
  int v = -1, t = -1, n = -1;
};

struct ObjMesh {
  std::vector<float> verts;    // T*9
  std::vector<float> normals;  // T*9
  std::vector<float> uvs;      // T*6
};

inline int resolve_index(long idx, size_t count) {
  // OBJ 1-based; negative = relative to end of the list parsed so far.
  return idx > 0 ? static_cast<int>(idx - 1) : static_cast<int>(count + idx);
}

inline Vec3 cross3(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- OBJ load
// Parses v/vt/vn/f (all face forms, negative indices, ngon fan
// triangulation); synthesizes geometric normals when vn is missing and zero
// UVs when vt is missing — the reference loader crashes on those inputs
// (utilities.h:822-824, SURVEY.md §2.3.11).
void* obj_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  if (std::fread(data.data(), 1, static_cast<size_t>(size), f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  std::vector<float> pos, tex, nrm;
  auto* mesh = new ObjMesh();

  const char* p = data.c_str();
  const char* end = p + data.size();
  std::vector<Corner> corners;
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    while (p < line_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p + 1 < line_end) {
      if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
        char* q = const_cast<char*>(p + 1);
        float a = std::strtof(q, &q), b = std::strtof(q, &q), c = std::strtof(q, &q);
        pos.push_back(a); pos.push_back(b); pos.push_back(c);
      } else if (p[0] == 'v' && p[1] == 't') {
        char* q = const_cast<char*>(p + 2);
        float a = std::strtof(q, &q);
        char* q2 = q;
        float b = std::strtof(q, &q2);
        tex.push_back(a); tex.push_back(q2 == q ? 0.f : b);
        // (second coord optional per spec)
      } else if (p[0] == 'v' && p[1] == 'n') {
        char* q = const_cast<char*>(p + 2);
        float a = std::strtof(q, &q), b = std::strtof(q, &q), c = std::strtof(q, &q);
        nrm.push_back(a); nrm.push_back(b); nrm.push_back(c);
      } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
        corners.clear();
        const char* q = p + 1;
        while (q < line_end) {
          while (q < line_end && std::isspace(static_cast<unsigned char>(*q))) ++q;
          if (q >= line_end) break;
          Corner c;
          char* r = const_cast<char*>(q);
          long vi = std::strtol(r, &r, 10);
          c.v = resolve_index(vi, pos.size() / 3);
          if (r < line_end && *r == '/') {
            ++r;
            if (*r != '/') {
              long ti = std::strtol(r, &r, 10);
              c.t = resolve_index(ti, tex.size() / 2);
            }
            if (r < line_end && *r == '/') {
              ++r;
              long ni = std::strtol(r, &r, 10);
              c.n = resolve_index(ni, nrm.size() / 3);
            }
          }
          corners.push_back(c);
          q = r;
        }
        for (size_t k = 1; k + 1 < corners.size(); ++k) {
          const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
          float v[9], n[9], uv[6];
          bool have_n = true;
          for (int j = 0; j < 3; ++j) {
            const Corner& c = tri[j];
            v[j * 3 + 0] = pos[c.v * 3 + 0];
            v[j * 3 + 1] = pos[c.v * 3 + 1];
            v[j * 3 + 2] = pos[c.v * 3 + 2];
            if (c.t >= 0) {
              uv[j * 2 + 0] = tex[c.t * 2 + 0];
              uv[j * 2 + 1] = tex[c.t * 2 + 1];
            } else {
              uv[j * 2 + 0] = uv[j * 2 + 1] = 0.f;
            }
            if (c.n >= 0) {
              n[j * 3 + 0] = nrm[c.n * 3 + 0];
              n[j * 3 + 1] = nrm[c.n * 3 + 1];
              n[j * 3 + 2] = nrm[c.n * 3 + 2];
            } else {
              have_n = false;
            }
          }
          if (!have_n) {
            Vec3 e1{v[3] - v[0], v[4] - v[1], v[5] - v[2]};
            Vec3 e2{v[6] - v[0], v[7] - v[1], v[8] - v[2]};
            Vec3 g = cross3(e1, e2);
            float len = std::sqrt(g.x * g.x + g.y * g.y + g.z * g.z);
            if (len > 0) {
              g.x /= len; g.y /= len; g.z /= len;
            } else {
              g = {0, 0, 1};
            }
            for (int j = 0; j < 3; ++j) {
              n[j * 3 + 0] = g.x; n[j * 3 + 1] = g.y; n[j * 3 + 2] = g.z;
            }
          }
          mesh->verts.insert(mesh->verts.end(), v, v + 9);
          mesh->normals.insert(mesh->normals.end(), n, n + 9);
          mesh->uvs.insert(mesh->uvs.end(), uv, uv + 6);
        }
      }
    }
    p = line_end + 1;
  }
  return mesh;
}

int obj_num_triangles(void* h) {
  return h ? static_cast<int>(static_cast<ObjMesh*>(h)->verts.size() / 9) : -1;
}

void obj_fill(void* h, float* v, float* n, float* uv) {
  auto* mesh = static_cast<ObjMesh*>(h);
  std::memcpy(v, mesh->verts.data(), mesh->verts.size() * sizeof(float));
  std::memcpy(n, mesh->normals.data(), mesh->normals.size() * sizeof(float));
  std::memcpy(uv, mesh->uvs.data(), mesh->uvs.size() * sizeof(float));
}

void obj_free(void* h) { delete static_cast<ObjMesh*>(h); }

// ---------------------------------------------------------------- BVH build
// Identical layout/semantics to accel/bvh.py::build_bvh: median split on
// the longest centroid axis (stable), DFS node order, children contiguous
// (left = i+1), escape link = i + subtree_size. Returns node count or -1.
struct BvhBuilder {
  const float* lo;
  const float* hi;
  const float* cent;
  float* box_lo;
  float* box_hi;
  int* first;
  int* count;
  int* order_out;
  int leaf_size;
  int max_nodes;
  int n_nodes = 0;
  int n_slots = 0;
  std::vector<int> scratch;

  int emit(int* idxs, int m) {
    if (n_nodes >= max_nodes) return -1;
    int node = n_nodes++;
    float blo[3] = {1e30f, 1e30f, 1e30f}, bhi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < m; ++i) {
      for (int a = 0; a < 3; ++a) {
        blo[a] = std::min(blo[a], lo[idxs[i] * 3 + a]);
        bhi[a] = std::max(bhi[a], hi[idxs[i] * 3 + a]);
      }
    }
    std::memcpy(box_lo + node * 3, blo, sizeof blo);
    std::memcpy(box_hi + node * 3, bhi, sizeof bhi);
    if (m <= leaf_size) {
      first[node] = n_slots;
      count[node] = m;
      std::memcpy(order_out + n_slots, idxs, static_cast<size_t>(m) * sizeof(int));
      n_slots += m;
      return node;
    }
    first[node] = -1;
    count[node] = 0;
    float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < m; ++i) {
      for (int a = 0; a < 3; ++a) {
        clo[a] = std::min(clo[a], cent[idxs[i] * 3 + a]);
        chi[a] = std::max(chi[a], cent[idxs[i] * 3 + a]);
      }
    }
    int axis = 0;
    float best = chi[0] - clo[0];
    for (int a = 1; a < 3; ++a) {
      if (chi[a] - clo[a] > best) {
        best = chi[a] - clo[a];
        axis = a;
      }
    }
    std::stable_sort(idxs, idxs + m, [&](int a, int b) {
      return cent[a * 3 + axis] < cent[b * 3 + axis];
    });
    int half = m / 2;
    if (emit(idxs, half) < 0) return -1;
    if (emit(idxs + half, m - half) < 0) return -1;
    return node;
  }
};

int bvh_build(const float* v0, const float* e1, const float* e2, const uint8_t* valid, int n,
              int leaf_size, float* box_lo, float* box_hi, int* first, int* count, int* miss,
              int* order_out, int max_nodes) {
  std::vector<int> rows;
  rows.reserve(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i)
    if (!valid || valid[i]) rows.push_back(i);
  if (rows.empty()) rows.push_back(0);
  int m = static_cast<int>(rows.size());

  std::vector<float> lo(static_cast<size_t>(m) * 3), hi(static_cast<size_t>(m) * 3),
      cent(static_cast<size_t>(m) * 3);
  for (int i = 0; i < m; ++i) {
    int r = rows[static_cast<size_t>(i)];
    for (int a = 0; a < 3; ++a) {
      float p0 = v0[r * 3 + a];
      float p1 = p0 + e1[r * 3 + a];
      float p2 = p0 + e2[r * 3 + a];
      float l = std::min(p0, std::min(p1, p2));
      float h2 = std::max(p0, std::max(p1, p2));
      lo[i * 3 + a] = l;
      hi[i * 3 + a] = h2;
      cent[i * 3 + a] = 0.5f * (l + h2);
    }
  }

  std::vector<int> idxs(static_cast<size_t>(m));
  std::iota(idxs.begin(), idxs.end(), 0);
  BvhBuilder b{lo.data(), hi.data(), cent.data(), box_lo, box_hi,
               first,     count,     order_out,   leaf_size, max_nodes};
  if (b.emit(idxs.data(), m) < 0) return -1;

  // Escape links from subtree sizes (children contiguous after parent).
  std::vector<int> size(static_cast<size_t>(b.n_nodes), 1);
  for (int i = b.n_nodes - 1; i >= 0; --i) {
    if (count[i] > 0) {
      size[static_cast<size_t>(i)] = 1;
    } else {
      int left = i + 1;
      int right = left + size[static_cast<size_t>(left)];
      size[static_cast<size_t>(i)] = 1 + size[static_cast<size_t>(left)] + size[static_cast<size_t>(right)];
    }
  }
  for (int i = 0; i < b.n_nodes; ++i) miss[i] = i + size[static_cast<size_t>(i)];

  // Remap slot ids to original scene rows.
  for (int i = 0; i < b.n_slots; ++i) order_out[i] = rows[static_cast<size_t>(order_out[i])];
  return b.n_nodes;
}


// ---------------------------------------------------------------------------
// Edge-table builder (grad/edges.py fast path): unique mesh edges with face
// adjacency by hashing quantized endpoint pairs. Mirrors the Python builder
// exactly (first-encounter order, first-two-faces on non-manifold edges) so
// the two produce identical tables (tests/test_torch_native.py).

struct EdgeKey {
  long long a[3];
  long long b[3];
  bool operator==(const EdgeKey& o) const {
    for (int i = 0; i < 3; ++i)
      if (a[i] != o.a[i] || b[i] != o.b[i]) return false;
    return true;
  }
};

struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    size_t h = 1469598103934665603ull;
    auto mix = [&h](long long v) {
      h ^= static_cast<size_t>(v);
      h *= 1099511628211ull;
    };
    for (int i = 0; i < 3; ++i) mix(k.a[i]);
    for (int i = 0; i < 3; ++i) mix(k.b[i]);
    return h;
  }
};

int edge_table_build(const float* v0, const float* e1, const float* e2,
                     const uint8_t* valid, int n, double q,
                     int* tri1, int* corner, int* tri2) {
  std::unordered_map<EdgeKey, int, EdgeKeyHash> seen;
  seen.reserve(static_cast<size_t>(n) * 2);
  int n_edges = 0;
  auto quant = [&](const float* p, long long* out) {
    for (int a = 0; a < 3; ++a)
      out[a] = static_cast<long long>(std::llround(static_cast<double>(p[a]) / q));
  };
  for (int t = 0; t < n; ++t) {
    if (!valid[t]) continue;
    float c[3][3];
    for (int a = 0; a < 3; ++a) {
      c[0][a] = v0[t * 3 + a];
      c[1][a] = v0[t * 3 + a] + e1[t * 3 + a];
      c[2][a] = v0[t * 3 + a] + e2[t * 3 + a];
    }
    for (int k = 0; k < 3; ++k) {
      long long qa[3], qb[3];
      quant(c[k], qa);
      quant(c[(k + 1) % 3], qb);
      // Canonical order: lexicographic min endpoint first (Python tuple <=).
      bool swap = false;
      for (int a = 0; a < 3; ++a) {
        if (qa[a] < qb[a]) break;
        if (qa[a] > qb[a]) { swap = true; break; }
      }
      EdgeKey key;
      for (int a = 0; a < 3; ++a) {
        key.a[a] = swap ? qb[a] : qa[a];
        key.b[a] = swap ? qa[a] : qb[a];
      }
      auto it = seen.find(key);
      if (it == seen.end()) {
        seen.emplace(key, n_edges);
        tri1[n_edges] = t;
        corner[n_edges] = k;
        tri2[n_edges] = -1;
        ++n_edges;
      } else {
        int e = it->second;
        if (tri2[e] == -1 && tri1[e] != t) tri2[e] = t;
      }
    }
  }
  return n_edges;
}

}  // extern "C"
