// Depth rasterizer — z-buffer render of a triangle mesh at pinhole cameras.
//
// TPU-native replacement for the reference's pyrender offscreen depth pass
// (the reference's mesher.py:444-480, extract_depth_from_mesh): the
// culling oracle renders the *extracted mesh's own* depth at every estimated
// camera so occluded geometry can be removed. No GL available here, so this
// is a plain perspective-correct scanline z-buffer (both windings kept,
// matching pyrender's SKIP_CULL_FACES).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 raster.cpp -o libraster.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// verts: [n_verts, 3] float32, tris: [n_tris, 3] int32,
// w2c:   [n_cams, 16] float32 row-major world->camera (OpenCV convention,
//        +z forward), out: [n_cams, H, W] float32 (0 where nothing hit).
void render_depth(const float* verts, int64_t n_verts,
                  const int32_t* tris, int64_t n_tris,
                  const float* w2c, int64_t n_cams,
                  float fx, float fy, float cx, float cy,
                  int H, int W, float znear, float zfar,
                  float* out) {
  std::vector<float> xc(n_verts), yc(n_verts), zc(n_verts);
  std::vector<float> uc(n_verts), vc(n_verts);

  for (int64_t c = 0; c < n_cams; ++c) {
    const float* M = w2c + 16 * c;
    float* depth = out + (int64_t)H * W * c;
    std::fill(depth, depth + (int64_t)H * W, 0.0f);

    for (int64_t i = 0; i < n_verts; ++i) {
      const float* p = verts + 3 * i;
      float x = M[0] * p[0] + M[1] * p[1] + M[2] * p[2] + M[3];
      float y = M[4] * p[0] + M[5] * p[1] + M[6] * p[2] + M[7];
      float z = M[8] * p[0] + M[9] * p[1] + M[10] * p[2] + M[11];
      xc[i] = x; yc[i] = y; zc[i] = z;
      if (z > znear) {
        uc[i] = fx * x / z + cx;
        vc[i] = fy * y / z + cy;
      } else {
        uc[i] = 0.0f; vc[i] = 0.0f;
      }
    }

    for (int64_t t = 0; t < n_tris; ++t) {
      int a = tris[3 * t], b = tris[3 * t + 1], d = tris[3 * t + 2];
      float z0 = zc[a], z1 = zc[b], z2 = zc[d];
      // near-clip: drop triangles touching the camera plane (the oracle is
      // conservative there; pyrender clips, geometry this close is noise)
      if (z0 <= znear || z1 <= znear || z2 <= znear) continue;
      if (z0 > zfar && z1 > zfar && z2 > zfar) continue;

      double u0 = uc[a], v0 = vc[a];
      double u1 = uc[b], v1 = vc[b];
      double u2 = uc[d], v2 = vc[d];

      int x_lo = std::max(0, (int)std::floor(std::min({u0, u1, u2})));
      int x_hi = std::min(W - 1, (int)std::ceil(std::max({u0, u1, u2})));
      int y_lo = std::max(0, (int)std::floor(std::min({v0, v1, v2})));
      int y_hi = std::min(H - 1, (int)std::ceil(std::max({v0, v1, v2})));
      if (x_lo > x_hi || y_lo > y_hi) continue;

      double area = (u1 - u0) * (v2 - v0) - (u2 - u0) * (v1 - v0);
      if (std::fabs(area) < 1e-12) continue;
      double inv_area = 1.0 / area;
      double w0 = 1.0 / z0, w1 = 1.0 / z1, w2 = 1.0 / z2;

      for (int py = y_lo; py <= y_hi; ++py) {
        for (int px = x_lo; px <= x_hi; ++px) {
          double qx = px + 0.0, qy = py + 0.0;  // sample at pixel centers
          double l0 = ((u1 - qx) * (v2 - qy) - (u2 - qx) * (v1 - qy))
                      * inv_area;
          double l1 = ((u2 - qx) * (v0 - qy) - (u0 - qx) * (v2 - qy))
                      * inv_area;
          double l2 = 1.0 - l0 - l1;
          // inside for either winding: all barycentrics share area's sign
          if (l0 < 0.0 || l1 < 0.0 || l2 < 0.0) continue;
          double invz = l0 * w0 + l1 * w1 + l2 * w2;
          if (invz <= 0.0) continue;
          float zpix = (float)(1.0 / invz);
          if (zpix > zfar) continue;
          float& cell = depth[(int64_t)py * W + px];
          if (cell == 0.0f || zpix < cell) cell = zpix;
        }
      }
    }
  }
}

}  // extern "C"
