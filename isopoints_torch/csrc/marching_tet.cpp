// Native marching-tetrahedra surface extraction.
//
// Host-side meshing runtime for isopoints_tpu (the reference ships its
// host-side geometry as C++/CUDA in DSS/csrc; here the TPU compute path
// is JAX/Pallas and this covers the CPU meshing hot loop that
// utils/meshing.py otherwise runs through numpy). Same 6-tetrahedra
// cube decomposition and global-edge vertex dedup as the Python
// implementation, single pass, O(1) amortized hash dedup.
//
// Build: g++ -O3 -march=native -shared -fPIC marching_tet.cpp -o libmarchingtet.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// cube corner offsets (x fastest), matching utils/meshing.py _CORNERS
const int kCorners[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// 6-tet decomposition sharing the 0-6 diagonal (_TETS)
const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// tet edges by local vertex pair (_TET_EDGES)
const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// case -> triangles as edge-index triples (_MT_TRIS); -1 terminated
const int kTris[16][7] = {
    /* 0*/ {-1, -1, -1, -1, -1, -1, -1},
    /* 1*/ {0, 1, 2, -1, -1, -1, -1},
    /* 2*/ {0, 3, 4, -1, -1, -1, -1},
    /* 3*/ {1, 2, 4, 1, 4, 3, -1},
    /* 4*/ {1, 3, 5, -1, -1, -1, -1},
    /* 5*/ {0, 2, 5, 0, 5, 3, -1},
    /* 6*/ {0, 4, 5, 0, 5, 1, -1},
    /* 7*/ {2, 5, 4, -1, -1, -1, -1},
    /* 8*/ {2, 4, 5, -1, -1, -1, -1},
    /* 9*/ {0, 1, 5, 0, 5, 4, -1},
    /*10*/ {0, 5, 2, 0, 3, 5, -1},
    /*11*/ {1, 5, 3, -1, -1, -1, -1},
    /*12*/ {1, 4, 2, 1, 3, 4, -1},
    /*13*/ {0, 4, 3, -1, -1, -1, -1},
    /*14*/ {0, 2, 1, -1, -1, -1, -1},
    /*15*/ {-1, -1, -1, -1, -1, -1, -1},
};

struct EdgeKeyHash {
  size_t operator()(uint64_t k) const {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return static_cast<size_t>(k);
  }
};

}  // namespace

extern "C" {

// Extract the `level` iso-surface of a (nx, ny, nz) scalar grid laid
// out C-contiguous as values[x][y][z]. Outputs are malloc'd; call
// mt_free on both. Returns 0 on success.
int marching_tets(const float* values, int64_t nx, int64_t ny, int64_t nz,
                  const float* origin, const float* spacing, float level,
                  float** out_verts, int64_t* n_verts,
                  int64_t** out_faces, int64_t* n_faces) {
  if (nx < 2 || ny < 2 || nz < 2) {
    *out_verts = nullptr;
    *out_faces = nullptr;
    *n_verts = 0;
    *n_faces = 0;
    return 0;
  }
  const int64_t syz = ny * nz;
  auto gidx = [&](int64_t x, int64_t y, int64_t z) {
    return x * syz + y * nz + z;
  };

  std::vector<float> verts;
  std::vector<int64_t> faces;
  verts.reserve(1 << 16);
  faces.reserve(1 << 16);
  // dedup on the global grid-vertex pair forming the crossed edge
  std::unordered_map<uint64_t, int64_t, EdgeKeyHash> edge_to_vid;
  edge_to_vid.reserve(1 << 16);

  const int64_t total = nx * ny * nz;

  auto vertex_on_edge = [&](int64_t ga, int64_t gb, float va, float vb) {
    if (ga > gb) {
      std::swap(ga, gb);
      std::swap(va, vb);
    }
    const uint64_t key =
        (static_cast<uint64_t>(ga) * static_cast<uint64_t>(total)) +
        static_cast<uint64_t>(gb);
    auto it = edge_to_vid.find(key);
    if (it != edge_to_vid.end()) return it->second;
    float t = 0.5f;
    const float denom = vb - va;
    if (denom != 0.0f) t = (level - va) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;
    const int64_t ax = ga / syz, ay = (ga / nz) % ny, az = ga % nz;
    const int64_t bx = gb / syz, by = (gb / nz) % ny, bz = gb % nz;
    const float px = origin[0] + spacing[0] * (ax + t * (bx - ax));
    const float py = origin[1] + spacing[1] * (ay + t * (by - ay));
    const float pz = origin[2] + spacing[2] * (az + t * (bz - az));
    const int64_t vid = static_cast<int64_t>(verts.size() / 3);
    verts.push_back(px);
    verts.push_back(py);
    verts.push_back(pz);
    edge_to_vid.emplace(key, vid);
    return vid;
  };

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      for (int64_t z = 0; z + 1 < nz; ++z) {
        int64_t cg[8];
        float cv[8];
        bool any_lo = false, any_hi = false;
        for (int c = 0; c < 8; ++c) {
          cg[c] = gidx(x + kCorners[c][0], y + kCorners[c][1],
                       z + kCorners[c][2]);
          cv[c] = values[cg[c]];
          if (cv[c] < level) any_lo = true; else any_hi = true;
        }
        if (!any_lo || !any_hi) continue;  // cube not crossed

        for (int t = 0; t < 6; ++t) {
          int inside = 0;
          int64_t tg[4];
          float tv[4];
          for (int v = 0; v < 4; ++v) {
            tg[v] = cg[kTets[t][v]];
            tv[v] = cv[kTets[t][v]];
            if (tv[v] < level) inside |= (1 << v);
          }
          const int* tris = kTris[inside];
          if (tris[0] < 0) continue;
          int64_t evid[6];
          // resolve needed edge vertices lazily
          for (int e = 0; e < 6; ++e) evid[e] = -1;
          for (int i = 0; i < 7 && tris[i] >= 0; ++i) {
            const int e = tris[i];
            if (evid[e] < 0) {
              const int a = kTetEdges[e][0], b = kTetEdges[e][1];
              evid[e] = vertex_on_edge(tg[a], tg[b], tv[a], tv[b]);
            }
          }
          for (int i = 0; i + 2 < 7 && tris[i] >= 0; i += 3) {
            faces.push_back(evid[tris[i]]);
            faces.push_back(evid[tris[i + 1]]);
            faces.push_back(evid[tris[i + 2]]);
          }
        }
      }
    }
  }

  *n_verts = static_cast<int64_t>(verts.size() / 3);
  *n_faces = static_cast<int64_t>(faces.size() / 3);
  *out_verts = static_cast<float*>(std::malloc(verts.size() * sizeof(float)));
  *out_faces =
      static_cast<int64_t*>(std::malloc(faces.size() * sizeof(int64_t)));
  if ((verts.size() && !*out_verts) || (faces.size() && !*out_faces)) {
    std::free(*out_verts);
    std::free(*out_faces);
    return 1;
  }
  if (verts.size())
    std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  if (faces.size())
    std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int64_t));
  return 0;
}

void mt_free(void* p) { std::free(p); }

}  // extern "C"
