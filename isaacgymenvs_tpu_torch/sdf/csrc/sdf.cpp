// Mesh -> signed distance field voxelizer (the port's copy of
// native/sdf/sdf.cpp, same algorithm and arithmetic, so that the port's grids
// equal the JAX package's).
//
// A mesh is voxelized once, on the host, into a dense signed-distance grid;
// the per-step queries are batched trilinear lookups on the card
// (isaacgymenvs_tpu_torch/sdf/builder.py sdf_query / engine/fused.py sdf_dyn).
//
// Algorithm (exact band + sweeping, SDFGen-style):
//   1. exact unsigned point-triangle distance in a band around each
//      triangle's padded voxel bbox;
//   2. sign from scanline parity of triangle crossings along +x rows;
//   3. 8-pass fast sweeping to propagate distances through the grid.
//
// Built with g++ into a plain shared library at first use
// (isaacgymenvs_tpu_torch/sdf/builder.py) and driven through ctypes.
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm2(const V3& a) { return dot(a, a); }

// exact point-triangle squared distance (Ericson, Real-Time Collision Detection)
double point_tri_dist2(const V3& p, const V3& a, const V3& b, const V3& c) {
  V3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return norm2(ap);
  V3 bp = sub(p, b);
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return norm2(bp);
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    V3 q = {a.x + v * ab.x, a.y + v * ab.y, a.z + v * ab.z};
    return norm2(sub(p, q));
  }
  V3 cp = sub(p, c);
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return norm2(cp);
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    V3 q = {a.x + w * ac.x, a.y + w * ac.y, a.z + w * ac.z};
    return norm2(sub(p, q));
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    V3 q = {b.x + w * (c.x - b.x), b.y + w * (c.y - b.y), b.z + w * (c.z - b.z)};
    return norm2(sub(p, q));
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  V3 q = {a.x + ab.x * v + ac.x * w, a.y + ab.y * v + ac.y * w,
          a.z + ab.z * v + ac.z * w};
  return norm2(sub(p, q));
}

}  // namespace

extern "C" {

// verts: (nv, 3) float64; tris: (nt, 3) int32; out: (nx*ny*nz) float32,
// x-major (index = (ix*ny + iy)*nz + iz). origin/spacing define the grid.
void mesh_to_sdf(const double* verts, int64_t nv, const int32_t* tris,
                 int64_t nt, double ox, double oy, double oz, double h,
                 int64_t nx, int64_t ny, int64_t nz, int band,
                 float* out) {
  const double BIG = 1e30;
  std::vector<double> dist((size_t)nx * ny * nz, BIG);
  std::vector<int> xing_count((size_t)ny * nz, 0);
  std::vector<std::vector<double>> xings((size_t)ny * nz);

  auto idx = [&](int64_t i, int64_t j, int64_t k) {
    return ((size_t)i * ny + j) * nz + k;
  };

  // 1. exact distances in a band around each triangle
  for (int64_t t = 0; t < nt; ++t) {
    V3 a{verts[3 * tris[3 * t + 0] + 0], verts[3 * tris[3 * t + 0] + 1],
         verts[3 * tris[3 * t + 0] + 2]};
    V3 b{verts[3 * tris[3 * t + 1] + 0], verts[3 * tris[3 * t + 1] + 1],
         verts[3 * tris[3 * t + 1] + 2]};
    V3 c{verts[3 * tris[3 * t + 2] + 0], verts[3 * tris[3 * t + 2] + 1],
         verts[3 * tris[3 * t + 2] + 2]};
    double lo[3] = {std::min({a.x, b.x, c.x}), std::min({a.y, b.y, c.y}),
                    std::min({a.z, b.z, c.z})};
    double hi[3] = {std::max({a.x, b.x, c.x}), std::max({a.y, b.y, c.y}),
                    std::max({a.z, b.z, c.z})};
    int64_t i0 = std::max<int64_t>(0, (int64_t)((lo[0] - ox) / h) - band);
    int64_t i1 = std::min<int64_t>(nx - 1, (int64_t)((hi[0] - ox) / h) + band + 1);
    int64_t j0 = std::max<int64_t>(0, (int64_t)((lo[1] - oy) / h) - band);
    int64_t j1 = std::min<int64_t>(ny - 1, (int64_t)((hi[1] - oy) / h) + band + 1);
    int64_t k0 = std::max<int64_t>(0, (int64_t)((lo[2] - oz) / h) - band);
    int64_t k1 = std::min<int64_t>(nz - 1, (int64_t)((hi[2] - oz) / h) + band + 1);
    for (int64_t i = i0; i <= i1; ++i)
      for (int64_t j = j0; j <= j1; ++j)
        for (int64_t k = k0; k <= k1; ++k) {
          V3 p{ox + i * h, oy + j * h, oz + k * h};
          double d2 = point_tri_dist2(p, a, b, c);
          double& cur = dist[idx(i, j, k)];
          if (d2 < cur * cur) cur = std::sqrt(d2);
        }

    // 2. record +x ray crossings per (y,z) row (watertight parity sign).
    // Rays are jittered off the lattice so they never pass exactly
    // through triangle edges/vertices (which would double- or
    // zero-count crossings).
    const double jy = 0.5231321e-3 * h, jz = 0.7412987e-3 * h;
    for (int64_t j = j0; j <= j1; ++j)
      for (int64_t k = k0; k <= k1; ++k) {
        double py = oy + j * h + jy, pz = oz + k * h + jz;
        // ray (x: -inf -> +inf) vs triangle in the yz-plane projection
        double d1 = (b.y - a.y) * (pz - a.z) - (b.z - a.z) * (py - a.y);
        double d2 = (c.y - b.y) * (pz - b.z) - (c.z - b.z) * (py - b.y);
        double d3 = (a.y - c.y) * (pz - c.z) - (a.z - c.z) * (py - c.y);
        bool has_neg = (d1 < 0) || (d2 < 0) || (d3 < 0);
        bool has_pos = (d1 > 0) || (d2 > 0) || (d3 > 0);
        if (has_neg && has_pos) continue;  // outside projection
        // barycentric x at (py, pz)
        double det = (b.y - a.y) * (c.z - a.z) - (c.y - a.y) * (b.z - a.z);
        if (std::fabs(det) < 1e-14) continue;  // degenerate in projection
        double w1 = ((b.y - py) * (c.z - pz) - (c.y - py) * (b.z - pz)) / det;
        double w2 = ((c.y - py) * (a.z - pz) - (a.y - py) * (c.z - pz)) / det;
        double w3 = 1.0 - w1 - w2;
        double xhit = w1 * a.x + w2 * b.x + w3 * c.x;
        xings[(size_t)j * nz + k].push_back(xhit);
      }
  }

  // 3. inside spans from sorted crossings; negate distances inside
  for (int64_t j = 0; j < ny; ++j)
    for (int64_t k = 0; k < nz; ++k) {
      auto& v = xings[(size_t)j * nz + k];
      if (v.empty()) continue;
      std::sort(v.begin(), v.end());
      for (int64_t i = 0; i < nx; ++i) {
        double px = ox + i * h;
        size_t n_before =
            std::upper_bound(v.begin(), v.end(), px) - v.begin();
        if (n_before % 2 == 1) dist[idx(i, j, k)] = -std::fabs(dist[idx(i, j, k)]);
      }
    }

  // 4. fast sweeping: 8 diagonal passes of the proper eikonal update
  //    (solve |grad d| = 1 from the smallest one-sided neighbor per axis)
  auto neighbor_min = [&](int64_t i, int64_t j, int64_t k, int axis) {
    double m = BIG;
    int64_t di = axis == 0, dj = axis == 1, dk = axis == 2;
    if (i - di >= 0 && j - dj >= 0 && k - dk >= 0)
      m = std::min(m, std::fabs(dist[idx(i - di, j - dj, k - dk)]));
    if (i + di < nx && j + dj < ny && k + dk < nz)
      m = std::min(m, std::fabs(dist[idx(i + di, j + dj, k + dk)]));
    return m;
  };
  auto sweep = [&](int si, int sj, int sk) {
    int64_t ib = si > 0 ? 0 : nx - 1, ie = si > 0 ? nx : -1;
    int64_t jb = sj > 0 ? 0 : ny - 1, je = sj > 0 ? ny : -1;
    int64_t kb = sk > 0 ? 0 : nz - 1, ke = sk > 0 ? nz : -1;
    for (int64_t i = ib; i != ie; i += si)
      for (int64_t j = jb; j != je; j += sj)
        for (int64_t k = kb; k != ke; k += sk) {
          double& d = dist[idx(i, j, k)];
          double a[3] = {neighbor_min(i, j, k, 0), neighbor_min(i, j, k, 1),
                         neighbor_min(i, j, k, 2)};
          std::sort(a, a + 3);
          double x = a[0] + h;
          if (x > a[1]) {
            double s2 = 2 * h * h - (a[0] - a[1]) * (a[0] - a[1]);
            x = 0.5 * (a[0] + a[1] + std::sqrt(std::max(0.0, s2)));
            if (x > a[2]) {
              double sum = a[0] + a[1] + a[2];
              double sq = sum * sum -
                          3 * (a[0] * a[0] + a[1] * a[1] + a[2] * a[2] -
                               h * h);
              x = (sum + std::sqrt(std::max(0.0, sq))) / 3.0;
            }
          }
          if (x < std::fabs(d)) d = (d < 0 ? -1.0 : 1.0) * x;
        }
  };
  for (int pass = 0; pass < 2; ++pass)
    for (int si : {1, -1})
      for (int sj : {1, -1})
        for (int sk : {1, -1}) sweep(si, sj, sk);

  for (size_t i = 0; i < dist.size(); ++i) out[i] = (float)dist[i];
}
}
