// trace_mask — the boundary tracer of the detection host stage (host code).
//
// A copy of the reference's geom_trace_mask and the result accessors it
// returns through (roadsurf_tpu/geom/native/geomcore.cpp), so the port
// traces every ring from the same start vertex and in the same order: RDP
// on a closed ring depends on its start vertex, and the records' order on
// the rings' order. Built with the host C++ compiler by geom/_native.py and
// loaded with ctypes.
//
// C ABI: geom_trace_mask returns an opaque handle; the accessors read its
// sizes, geom_result_copy copies it out, geom_result_free frees it. Every
// ring is one polygon of one ring:
//   xy          : double[2*total_points]  (closed rings, x = col, y = row)
//   ring_sizes  : int32[nrings]           (points per ring)
//   poly_rings  : int32[npolys]           (all 1)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct GeomResult {
  std::vector<double> xy;
  std::vector<int32_t> ring_sizes;
  std::vector<int32_t> poly_rings;
};

}  // namespace

extern "C" {

int64_t geom_result_num_coords(GeomResult* r) { return (int64_t)r->xy.size() / 2; }
int32_t geom_result_num_rings(GeomResult* r) { return (int32_t)r->ring_sizes.size(); }
int32_t geom_result_num_polys(GeomResult* r) { return (int32_t)r->poly_rings.size(); }

void geom_result_copy(GeomResult* r, double* xy, int32_t* ring_sizes,
                      int32_t* poly_rings) {
  std::memcpy(xy, r->xy.data(), r->xy.size() * sizeof(double));
  std::memcpy(ring_sizes, r->ring_sizes.data(),
              r->ring_sizes.size() * sizeof(int32_t));
  std::memcpy(poly_rings, r->poly_rings.data(),
              r->poly_rings.size() * sizeof(int32_t));
}

void geom_result_free(GeomResult* r) { delete r; }

// --- mask boundary tracing: pixel-exact rectilinear rings ------------------
// Directed boundary edges between filled and empty pixels (interior kept on
// a consistent side), linked into closed rings; exteriors get positive
// shoelace area in the y-down pixel frame, holes negative. Mirrors the
// plain Python tracer in roadsurf_tpu_torch/geom/vectorize.py.
GeomResult* geom_trace_mask(const uint8_t* mask, int height, int width) {
  const int W1 = width + 1;
  const int nverts = (height + 1) * W1;
  std::vector<int32_t> e1(nverts, -1), e2(nverts, -1);
  int64_t nedges = 0;
  auto add = [&](int a, int b) {
    if (e1[a] < 0) e1[a] = b; else e2[a] = b;
    nedges++;
  };
  for (int r = 0; r < height; r++) {
    const uint8_t* row = mask + (size_t)r * width;
    for (int c = 0; c < width; c++) {
      if (!row[c]) continue;
      bool top = (r == 0) || !mask[(size_t)(r - 1) * width + c];
      bool bot = (r == height - 1) || !mask[(size_t)(r + 1) * width + c];
      bool lef = (c == 0) || !row[c - 1];
      bool rig = (c == width - 1) || !row[c + 1];
      int tl = r * W1 + c, tr = tl + 1;
      int bl = (r + 1) * W1 + c, br = bl + 1;
      if (top) add(tl, tr);
      if (bot) add(br, bl);
      if (lef) add(bl, tl);
      if (rig) add(tr, br);
    }
  }
  auto* res = new GeomResult();
  std::vector<int> ring;
  for (int start = 0; start < nverts && nedges > 0; start++) {
    if (e1[start] < 0) continue;
    ring.clear();
    ring.push_back(start);
    int cur = start, pdx = 0, pdy = 0;
    int64_t guard = nedges + 1;
    while (guard-- > 0) {
      int nxt;
      if (e2[cur] < 0) {
        nxt = e1[cur];
        e1[cur] = -1;
      } else {
        // checkerboard corner: prefer the smaller turn (cross product of
        // incoming x outgoing) so each ring stays simple — same rule as
        // the Python tracer
        int c1 = e1[cur], c2 = e2[cur];
        auto turn = [&](int to) {
          int dx = (to % W1) - (cur % W1);
          int dy = (to / W1) - (cur / W1);
          return pdx * dy - pdy * dx;
        };
        if (turn(c1) <= turn(c2)) {
          nxt = c1;
          e1[cur] = e2[cur];
          e2[cur] = -1;
        } else {
          nxt = c2;
          e2[cur] = -1;
        }
      }
      nedges--;
      pdx = (nxt % W1) - (cur % W1);
      pdy = (nxt / W1) - (cur / W1);
      cur = nxt;
      ring.push_back(cur);
      if (cur == start) break;
    }
    if (ring.size() >= 5 && ring.front() == ring.back()) {
      res->ring_sizes.push_back((int32_t)ring.size());
      res->poly_rings.push_back(1);
      for (int v : ring) {
        res->xy.push_back((double)(v % W1));
        res->xy.push_back((double)(v / W1));
      }
    }
  }
  return res;
}

}  // extern "C"
