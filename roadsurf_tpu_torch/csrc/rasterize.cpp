// rasterize -- the polygon fill of the training data loader (host code).
//
// A copy of the reference's geom_rasterize and the ring reader it goes
// through (roadsurf_tpu/geom/native/geomcore.cpp: readPolySet, snapPt), so
// the port's instance bitmaps equal the reference's pixel for pixel: an
// even-odd scanline fill sampled at pixel centres, vertices snapped to
// multiples of 1e-9 first, closing and repeated vertices dropped. Built
// with the host C++ compiler by geom/_native.py and loaded with ctypes.
//
// C ABI: geom_rasterize(xy, ring_sizes, nrings, poly_rings, npolys, x0, dx,
// y0, dy, height, width, out, value) sets out[row * width + col] = value
// for every pixel centre x = x0 + (col + 0.5) * dx, y = y0 + (row + 0.5) *
// dy inside the rings (even-odd over all rings).
//   xy          : double[2*total_points]  (x, y of each ring's points)
//   ring_sizes  : int32[nrings]           (points per ring)
//   poly_rings  : int32[npolys]           (rings per polygon; unused here)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Pt {
  double x, y;
  bool operator==(const Pt& o) const { return x == o.x && y == o.y; }
};

const double SNAP = 1e-9;
inline double snap1(double v) { return std::round(v / SNAP) * SNAP; }
inline Pt snapPt(const Pt& p) { return Pt{snap1(p.x), snap1(p.y)}; }

std::vector<std::vector<Pt>> readRings(const double* xy,
                                       const int32_t* ring_sizes,
                                       int nrings) {
  std::vector<std::vector<Pt>> rings;
  const double* p = xy;
  for (int i = 0; i < nrings; i++) {
    int sz = ring_sizes[i];
    std::vector<Pt> ring;
    ring.reserve(sz);
    for (int j = 0; j < sz; j++) {
      ring.push_back(snapPt(Pt{p[0], p[1]}));
      p += 2;
    }
    // drop explicit closing point
    while (ring.size() > 1 && ring.front() == ring.back()) ring.pop_back();
    // drop consecutive duplicates
    std::vector<Pt> clean;
    for (auto& q : ring)
      if (clean.empty() || !(clean.back() == q)) clean.push_back(q);
    rings.push_back(std::move(clean));
  }
  return rings;
}

}  // namespace

extern "C" {

void geom_rasterize(const double* xy, const int32_t* ring_sizes, int nrings,
                    const int32_t* poly_rings, int npolys, double x0,
                    double dx, double y0, double dy, int height, int width,
                    uint8_t* out, uint8_t value) {
  (void)poly_rings;
  (void)npolys;
  const std::vector<std::vector<Pt>> rings =
      readRings(xy, ring_sizes, nrings);
  std::vector<double> xs;
  for (int row = 0; row < height; row++) {
    double py = y0 + (row + 0.5) * dy;
    xs.clear();
    for (auto& r : rings) {
      size_t n = r.size();
      if (n < 3) continue;
      for (size_t i = 0; i < n; i++) {
        const Pt& a = r[i];
        const Pt& b = r[(i + 1) % n];
        if ((a.y <= py && b.y > py) || (b.y <= py && a.y > py)) {
          double t = (py - a.y) / (b.y - a.y);
          xs.push_back(a.x + t * (b.x - a.x));
        }
      }
    }
    if (xs.empty()) continue;
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      // pixel centers in [xs[k], xs[k+1])
      int c0 = (int)std::ceil((xs[k] - x0) / dx - 0.5);
      int c1 = (int)std::floor((xs[k + 1] - x0) / dx - 0.5);
      c0 = std::max(c0, 0);
      c1 = std::min(c1, width - 1);
      for (int c = c0; c <= c1; c++) out[row * width + c] = value;
    }
  }
}

}  // extern "C"
