// Isosurface extraction — marching tetrahedra with vertex dedup.
//
// Native replacement for the reference's external `mcubes` dependency
// (InstantNeuS.py:471).  Each grid cell is split into 6 tetrahedra; every
// tetrahedron contributes 0-2 triangles depending on its sign pattern
// (16 cases, enumerated from first principles — no lookup-table
// transcription).  Shared edge vertices are deduplicated with a hash map
// so the mesh is watertight where the field is.
//
// Build: g++ -O3 -shared -fPIC marching.cpp -o libmarching.so
// API (ctypes): mc_run(grid, nx, ny, nz, iso) -> Mesh*; mc_free(Mesh*).
// Vertices are in voxel-index coordinates (x, y, z along dims 0, 1, 2).

#include <cstdint>
#include <cstdlib>
#include <unordered_map>
#include <vector>

extern "C" {

struct Mesh {
  float* verts;
  int64_t n_verts;
  int32_t* tris;
  int64_t n_tris;
};

}  // extern "C"

namespace {

struct Builder {
  const float* g;
  int64_t nx, ny, nz;
  float iso;
  std::vector<float> verts;
  std::vector<int32_t> tris;
  std::unordered_map<uint64_t, int32_t> edge_cache;

  inline float at(int64_t x, int64_t y, int64_t z) const {
    return g[(x * ny + y) * nz + z];
  }

  // unique id for a lattice point
  inline uint64_t pid(int64_t x, int64_t y, int64_t z) const {
    return (uint64_t)((x * ny + y) * nz + z);
  }

  // interpolated vertex on the edge between lattice points a and b
  int32_t edge_vertex(int64_t ax, int64_t ay, int64_t az,
                      int64_t bx, int64_t by, int64_t bz) {
    uint64_t ka = pid(ax, ay, az), kb = pid(bx, by, bz);
    uint64_t key = ka < kb ? (ka << 32 | kb) : (kb << 32 | ka);
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;

    float va = at(ax, ay, az), vb = at(bx, by, bz);
    float t = (iso - va) / (vb - va + 1e-30f);
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    float px = ax + t * (bx - ax);
    float py = ay + t * (by - ay);
    float pz = az + t * (bz - az);
    int32_t idx = (int32_t)(verts.size() / 3);
    verts.push_back(px);
    verts.push_back(py);
    verts.push_back(pz);
    edge_cache.emplace(key, idx);
    return idx;
  }

  // one tetrahedron given 4 lattice corners
  void tetra(const int64_t p[4][3]) {
    float v[4];
    int above = 0, mask = 0;
    for (int i = 0; i < 4; i++) {
      v[i] = at(p[i][0], p[i][1], p[i][2]);
      if (v[i] > iso) { mask |= 1 << i; above++; }
    }
    if (above == 0 || above == 4) return;

    // indices of corners above / below
    int hi[4], lo[4], nh = 0, nl = 0;
    for (int i = 0; i < 4; i++) {
      if (mask & (1 << i)) hi[nh++] = i; else lo[nl++] = i;
    }

    auto EV = [&](int a, int b) {
      return edge_vertex(p[a][0], p[a][1], p[a][2],
                         p[b][0], p[b][1], p[b][2]);
    };

    if (above == 1) {  // single triangle around the lone high corner
      int a = hi[0];
      int32_t e0 = EV(a, lo[0]), e1 = EV(a, lo[1]), e2 = EV(a, lo[2]);
      tris.push_back(e0); tris.push_back(e1); tris.push_back(e2);
    } else if (above == 3) {  // single triangle around the lone low corner
      int a = lo[0];
      int32_t e0 = EV(a, hi[0]), e1 = EV(a, hi[1]), e2 = EV(a, hi[2]);
      tris.push_back(e0); tris.push_back(e2); tris.push_back(e1);
    } else {  // quad between the two high and two low corners
      int a = hi[0], b = hi[1], c = lo[0], d = lo[1];
      int32_t e_ac = EV(a, c), e_ad = EV(a, d);
      int32_t e_bc = EV(b, c), e_bd = EV(b, d);
      tris.push_back(e_ac); tris.push_back(e_ad); tris.push_back(e_bd);
      tris.push_back(e_ac); tris.push_back(e_bd); tris.push_back(e_bc);
    }
  }

  void run() {
    // Kuhn 6-tetra decomposition (coordinate-insertion permutations):
    // every boundary-face diagonal runs min-corner -> max-corner in global
    // coordinates, so adjacent cells' triangulations agree and the output
    // is watertight wherever the field is.
    static const int T[6][4] = {
        {0, 1, 2, 6}, {0, 1, 5, 6}, {0, 3, 2, 6},
        {0, 3, 7, 6}, {0, 4, 5, 6}, {0, 4, 7, 6},
    };
    // cube corner offsets (x, y, z)
    static const int C[8][3] = {
        {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
        {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
    };

    for (int64_t x = 0; x + 1 < nx; x++)
      for (int64_t y = 0; y + 1 < ny; y++)
        for (int64_t z = 0; z + 1 < nz; z++) {
          // cheap skip: all 8 on one side
          bool any_hi = false, any_lo = false;
          for (int c = 0; c < 8; c++) {
            float v = at(x + C[c][0], y + C[c][1], z + C[c][2]);
            if (v > iso) any_hi = true; else any_lo = true;
          }
          if (!any_hi || !any_lo) continue;

          for (int t = 0; t < 6; t++) {
            int64_t p[4][3];
            for (int k = 0; k < 4; k++) {
              const int* cc = C[T[t][k]];
              p[k][0] = x + cc[0];
              p[k][1] = y + cc[1];
              p[k][2] = z + cc[2];
            }
            tetra(p);
          }
        }
  }
};

}  // namespace

extern "C" {

Mesh* mc_run(const float* grid, int64_t nx, int64_t ny, int64_t nz,
             float iso) {
  Builder b;
  b.g = grid;
  b.nx = nx;
  b.ny = ny;
  b.nz = nz;
  b.iso = iso;
  b.run();

  Mesh* m = new Mesh;
  m->n_verts = (int64_t)(b.verts.size() / 3);
  m->n_tris = (int64_t)(b.tris.size() / 3);
  m->verts = (float*)malloc(b.verts.size() * sizeof(float));
  m->tris = (int32_t*)malloc(b.tris.size() * sizeof(int32_t));
  std::copy(b.verts.begin(), b.verts.end(), m->verts);
  std::copy(b.tris.begin(), b.tris.end(), m->tris);
  return m;
}

void mc_free(Mesh* m) {
  if (!m) return;
  free(m->verts);
  free(m->tris);
  delete m;
}

}  // extern "C"
