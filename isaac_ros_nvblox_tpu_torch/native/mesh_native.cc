// Native mesh post-processing of the PyTorch port: per-block compaction of
// the device mesh soup, vertex welding and binary PLY serialization (the
// port's copy of native/mesh_native.cc, the JAX package's host library).
//
// Role parity: the reference keeps its mesh serialization / streaming path
// in C++ (nvblox_ros/src/lib/conversions/mesh_conversions.cpp,
// layer_publishing.cpp) because it is host-side, latency-sensitive work.
// The device produces fixed-capacity triangle soup (ops/mesh_cuda.py);
// these routines do the variable-length host side:
//
//   compact_triangles:  packed triangles of a soup + valid mask
//   mesh_block_offsets / mesh_block_compact: per-block CSR compaction
//   weld_mesh:          quantized-vertex dedup -> vertex + index buffers
//   write_mesh_ply:     binary little-endian PLY with optional colors
//
// Built with g++ on first use and bound with ctypes (native/__init__.py):
// a plain C interface.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Count valid triangles in a mask of length n.
int64_t count_valid(const uint8_t* valid, int64_t n) {
  int64_t c = 0;
  for (int64_t i = 0; i < n; ++i) c += valid[i] != 0;
  return c;
}

// Compact triangle soup: verts/colors are [n_tris_total, 3, 3] float32,
// valid is [n_tris_total] u8. Writes packed copies into out_* (callers size
// them with count_valid). Returns number of triangles written.
int64_t compact_triangles(const float* verts, const float* colors,
                          const uint8_t* valid, int64_t n_tris,
                          float* out_verts, float* out_colors) {
  int64_t w = 0;
  for (int64_t i = 0; i < n_tris; ++i) {
    if (!valid[i]) continue;
    std::memcpy(out_verts + w * 9, verts + i * 9, 9 * sizeof(float));
    std::memcpy(out_colors + w * 9, colors + i * 9, 9 * sizeof(float));
    ++w;
  }
  return w;
}

struct Key3 {
  int64_t x, y, z;
  bool operator==(const Key3& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};
struct Key3Hash {
  size_t operator()(const Key3& k) const {
    // 3-component spatial hash (same deco-hash family as the reference's
    // Index3DHash: x + 17191*y + 17191^2*z, nvblox_hash_utils.h:40-49).
    return static_cast<size_t>(k.x) + 17191u * static_cast<size_t>(k.y) +
           17191u * 17191u * static_cast<size_t>(k.z);
  }
};

// Weld vertices of a triangle soup. verts/colors: [n_tris, 3, 3] f32.
// Quantization: round(v / quantum). Outputs:
//   out_verts / out_colors: [<= n_tris*3, 3]
//   out_tris: [n_tris, 3] int32 indices
// Returns the number of unique vertices.
int64_t weld_mesh(const float* verts, const float* colors, int64_t n_tris,
                  float quantum, float* out_verts, uint8_t* out_colors,
                  int32_t* out_tris) {
  std::unordered_map<Key3, int32_t, Key3Hash> index;
  index.reserve(static_cast<size_t>(n_tris) * 2);
  int64_t n_unique = 0;
  const float inv_q = 1.0f / quantum;
  for (int64_t t = 0; t < n_tris; ++t) {
    for (int k = 0; k < 3; ++k) {
      const float* v = verts + (t * 3 + k) * 3;
      const float* c = colors + (t * 3 + k) * 3;
      Key3 key{static_cast<int64_t>(std::llroundf(v[0] * inv_q)),
               static_cast<int64_t>(std::llroundf(v[1] * inv_q)),
               static_cast<int64_t>(std::llroundf(v[2] * inv_q))};
      auto it = index.find(key);
      int32_t id;
      if (it == index.end()) {
        id = static_cast<int32_t>(n_unique++);
        index.emplace(key, id);
        std::memcpy(out_verts + id * 3, v, 3 * sizeof(float));
        for (int j = 0; j < 3; ++j) {
          float cv = c[j];
          out_colors[id * 3 + j] =
              static_cast<uint8_t>(cv < 0 ? 0 : (cv > 255 ? 255 : cv));
        }
      } else {
        id = it->second;
      }
      out_tris[t * 3 + k] = id;
    }
  }
  return n_unique;
}

// Binary little-endian PLY with vertex colors. Returns 0 on success.
// Per-block CSR compaction of the device mesh kernel's fixed-capacity
// triangle soup (role parity: the per-block serialized-mesh packing of
// layer_publishing.cpp / mesh_conversions.cpp, which the reference keeps
// in C++ for the same publish-latency reason).
//
// verts:  [N, 3, K, V] f32 vertex components (xyz-major planes)
// colors: [N, 3, K, V] f32 or null
// mask:   [N, K, V] u8 (1 = slot holds a live triangle vertex)
// Emission order per block matches the numpy path: v-major, then slot k.
//
// Pass 1: offsets[i+1] = live vertices of block i (exclusive prefix sum,
// offsets[0] = 0, length N+1).
void mesh_block_offsets(const uint8_t* mask, int64_t N, int64_t K, int64_t V,
                        int64_t* offsets) {
  offsets[0] = 0;
  for (int64_t i = 0; i < N; ++i) {
    const uint8_t* m = mask + i * K * V;
    int64_t c = 0;
    for (int64_t j = 0; j < K * V; ++j) c += m[j] != 0;
    offsets[i + 1] = offsets[i] + c;
  }
}

// Pass 2: pack [total, 3] vertices (+ colors) per block at offsets.
void mesh_block_compact(const float* verts, const float* colors,
                        const uint8_t* mask, int64_t N, int64_t K, int64_t V,
                        const int64_t* offsets, float* out_v, float* out_c) {
  for (int64_t i = 0; i < N; ++i) {
    const uint8_t* m = mask + i * K * V;
    const float* vx = verts + ((i * 3 + 0) * K) * V;
    const float* vy = verts + ((i * 3 + 1) * K) * V;
    const float* vz = verts + ((i * 3 + 2) * K) * V;
    int64_t w = offsets[i];
    for (int64_t v = 0; v < V; ++v) {
      for (int64_t k = 0; k < K; ++k) {
        if (!m[k * V + v]) continue;
        out_v[w * 3 + 0] = vx[k * V + v];
        out_v[w * 3 + 1] = vy[k * V + v];
        out_v[w * 3 + 2] = vz[k * V + v];
        if (colors != nullptr) {
          const float* cx = colors + ((i * 3 + 0) * K) * V;
          const float* cy = colors + ((i * 3 + 1) * K) * V;
          const float* cz = colors + ((i * 3 + 2) * K) * V;
          out_c[w * 3 + 0] = cx[k * V + v];
          out_c[w * 3 + 1] = cy[k * V + v];
          out_c[w * 3 + 2] = cz[k * V + v];
        }
        ++w;
      }
    }
  }
}

int write_mesh_ply(const char* path, const float* verts,
                   const uint8_t* colors, int64_t n_verts,
                   const int32_t* tris, int64_t n_tris, int has_colors) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  fprintf(f,
          "ply\nformat binary_little_endian 1.0\nelement vertex %lld\n"
          "property float x\nproperty float y\nproperty float z\n",
          static_cast<long long>(n_verts));
  if (has_colors) {
    fprintf(f,
            "property uchar red\nproperty uchar green\nproperty uchar blue\n");
  }
  fprintf(f,
          "element face %lld\nproperty list uchar int vertex_indices\n"
          "end_header\n",
          static_cast<long long>(n_tris));
  for (int64_t i = 0; i < n_verts; ++i) {
    fwrite(verts + i * 3, sizeof(float), 3, f);
    if (has_colors) fwrite(colors + i * 3, 1, 3, f);
  }
  for (int64_t i = 0; i < n_tris; ++i) {
    uint8_t n = 3;
    fwrite(&n, 1, 1, f);
    fwrite(tris + i * 3, sizeof(int32_t), 3, f);
  }
  return fclose(f) == 0 ? 0 : 2;
}

}  // extern "C"
