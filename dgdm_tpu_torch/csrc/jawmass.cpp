// The 2D jaw mass on the host: the area of one oracle jaw, the convex hull of
// its whole strip plus the hulls of its 50 overlapping slabs, as
// dgdm_tpu_torch/geom/polygon.py:finger_cross_section_area_py computes it in
// Python (the JAX package's dgdm_tpu/geom/polygon.py does the same).
//
// The result is the same double as the Python body's, not a close one. Each
// step repeats the Python's operations in its order:
//   - the point sets: (x_i, y_lo_i) and (x_i, y_hi_i) of the strip, then of
//     each slab [bounds[s], bounds[s + 1] + 1), cut at n as a slice is;
//   - np.unique(axis=0): a lexicographic sort by (x, y) and an exact dedupe;
//   - the monotone chain of convex_hull, each half started empty, popping
//     while the cross product, written term for term as there, is <= 0;
//     the hull is lower[:-1] + upper[:-1];
//   - the shoelace of polygon_area_centroid_inertia, cross = x * y1 - x1 * y
//     with (x1, y1) the next vertex, summed in numpy's pairwise order
//     (np.add.reduce from 0.0 over a contiguous float64 array), times 0.5;
//   - the strip's area, then each slab's added to it in turn.
// Built with -ffp-contract=off, so that no multiply and add are fused, and
// with neither -ffast-math nor -march=native: the bits do not depend on the
// host's instruction set (geom/jawmass.py builds it).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// numpy's pairwise summation of a contiguous float64 array
// (pairwise_sum in numpy/_core/src/umath/loops_utils.h.src): a plain loop
// under 8 items, 8 interleaved partial sums up to 128, halves beyond.
double pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// convex_hull's half(): one chain over pts in the given order.
void half(const std::vector<Pt>& pts, bool reverse, std::vector<Pt>& h) {
  h.clear();
  const int64_t n = static_cast<int64_t>(pts.size());
  for (int64_t k = 0; k < n; ++k) {
    const Pt& p = pts[reverse ? n - 1 - k : k];
    while (h.size() >= 2) {
      const Pt& a = h[h.size() - 2];
      const Pt& b = h[h.size() - 1];
      const double c = (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x);
      if (c <= 0.0)
        h.pop_back();
      else
        break;
    }
    h.push_back(p);
  }
}

struct Work {
  std::vector<Pt> pts, lower, upper, hull;
  std::vector<double> cross;
};

// polygon_area_centroid_inertia(convex_hull(pts))[0]; sorts pts in place.
double hull_area(Work& w) {
  std::vector<Pt>& pts = w.pts;
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt& a, const Pt& b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  const std::vector<Pt>* verts = &pts;
  if (pts.size() > 2) {
    half(pts, false, w.lower);
    half(pts, true, w.upper);
    w.hull.assign(w.lower.begin(), w.lower.end() - 1);
    w.hull.insert(w.hull.end(), w.upper.begin(), w.upper.end() - 1);
    verts = &w.hull;
  }
  const std::vector<Pt>& v = *verts;
  const int64_t m = static_cast<int64_t>(v.size());
  w.cross.resize(m);
  for (int64_t i = 0; i < m; ++i) {
    const Pt& p = v[i];
    const Pt& q = v[(i + 1) % m];
    w.cross[i] = p.x * q.y - q.x * p.y;
  }
  // np.sum starts its reduction from add's identity, 0.0
  return 0.5 * (0.0 + pairwise_sum(w.cross.data(), m));
}

void collect(const double* x, const double* y_lo, const double* y_hi,
             int64_t lo, int64_t hi, std::vector<Pt>& pts) {
  pts.clear();
  for (int64_t i = lo; i < hi; ++i) pts.push_back({x[i], y_lo[i]});
  for (int64_t i = lo; i < hi; ++i) pts.push_back({x[i], y_hi[i]});
}

}  // namespace

extern "C" {

// One jaw: n samples (x, y_lo) of its curve and (x, y_hi) of the strip's
// other edge (y_lo + width), num_slabs + 1 slab bounds. Returns the area,
// per unit of density and height.
double jaw_area(const double* x, const double* y_lo, const double* y_hi,
                int64_t n, const int64_t* bounds, int64_t num_slabs) {
  Work w;
  collect(x, y_lo, y_hi, 0, n, w.pts);
  double area = hull_area(w);
  for (int64_t s = 0; s < num_slabs; ++s) {
    collect(x, y_lo, y_hi, bounds[s], std::min(bounds[s + 1] + 1, n), w.pts);
    area += hull_area(w);
  }
  return area;
}

}  // extern "C"
