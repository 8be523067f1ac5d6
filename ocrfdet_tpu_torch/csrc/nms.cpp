// Rotated-rectangle IoU + greedy NMS on the host (C plain ABI, loaded
// via ctypes by ocrfdet_tpu_torch/ops/nms.py, which builds it with
// `c++ -O3 -shared -fPIC` at first use).
//
// A copy of native/nms.cpp, the JAX package's replacement for the
// reference's mmcv CUDA nms_rotated (mmdet3d/core/post_processing/
// box3d_nms.py:231-268): NMS runs on the host after the decode, where a
// tight C++ loop over <= 1000 boxes per task beats a device round trip.
//
// Box layout: (cx, cy, dx, dy, yaw), yaw counter-clockwise radians.
// Intersection by Sutherland–Hodgman convex clipping.
//
// One change from native/nms.cpp: `pair_iou` first tests the boxes'
// circumscribed circles and returns 0 for pairs whose circles do not
// meet (such boxes cannot intersect, so their IoU is 0 either way). At
// the flagship's 500 decoded boxes per task most pairs are far apart,
// and the test skips their polygon clip.
//
// On the card the pair tests run in csrc/nms.cu, which builds each
// task's suppression rows with this file's arithmetic; the host then runs
// only the greedy scan over those rows (nms_scan_rows).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

void corners(const double* b, Pt out[4]) {
  const double c = std::cos(b[4]), s = std::sin(b[4]);
  const double hx = b[2] * 0.5, hy = b[3] * 0.5;
  const double lx[4] = {hx, -hx, -hx, hx};
  const double ly[4] = {hy, hy, -hy, -hy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = b[0] + c * lx[i] - s * ly[i];
    out[i].y = b[1] + s * lx[i] + c * ly[i];
  }
}

double poly_area(const std::vector<Pt>& p) {
  if (p.size() < 3) return 0.0;
  double a = 0.0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  return std::fabs(a) * 0.5;
}

double inter_area(const Pt a[4], const Pt b[4]) {
  std::vector<Pt> poly(a, a + 4), next;
  for (int i = 0; i < 4 && !poly.empty(); ++i) {
    const Pt& e0 = b[i];
    const Pt& e1 = b[(i + 1) % 4];
    next.clear();
    Pt prev = poly.back();
    bool prev_in = cross(e0, e1, prev) >= 0.0;
    for (const Pt& cur : poly) {
      bool cur_in = cross(e0, e1, cur) >= 0.0;
      if (cur_in != prev_in) {
        // edge intersection
        double dx = cur.x - prev.x, dy = cur.y - prev.y;
        double ex = e1.x - e0.x, ey = e1.y - e0.y;
        double den = ex * dy - ey * dx;
        if (std::fabs(den) > 1e-12) {
          double t = (ex * (e0.y - prev.y) - ey * (e0.x - prev.x)) / den;
          next.push_back({prev.x + t * dx, prev.y + t * dy});
        }
      }
      if (cur_in) next.push_back(cur);
      prev = cur;
      prev_in = cur_in;
    }
    poly.swap(next);
  }
  return poly_area(poly);
}

double pair_iou(const double* a, const double* b) {
  const double ra = 0.5 * std::sqrt(a[2] * a[2] + a[3] * a[3]);
  const double rb = 0.5 * std::sqrt(b[2] * b[2] + b[3] * b[3]);
  const double ex = a[0] - b[0], ey = a[1] - b[1];
  if (ex * ex + ey * ey > (ra + rb) * (ra + rb)) return 0.0;
  Pt ca[4], cb[4];
  corners(a, ca);
  corners(b, cb);
  const double inter = inter_area(ca, cb);
  const double uni = a[2] * a[3] + b[2] * b[3] - inter;
  return uni > 1e-12 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

void rotated_iou_matrix(const double* a, int na, const double* b, int nb,
                        double* out) {
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j)
      out[i * nb + j] = pair_iou(a + 5 * i, b + 5 * j);
}

// boxes sorted by descending score; returns number kept and writes
// kept indices (into the sorted order) to `keep`.
int nms_rotated(const double* boxes, int n, double iou_thr, int64_t* keep) {
  std::vector<char> suppressed(n, 0);
  int m = 0;
  for (int i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    keep[m++] = i;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      if (pair_iou(boxes + 5 * i, boxes + 5 * j) > iou_thr) suppressed[j] = 1;
    }
  }
  return m;
}

// Greedy scan over suppression rows (csrc/nms.cu): rows [*, words], bit
// j of row i set if box i, kept, suppresses box j; order [n] the
// candidates' rows, best score first. Writes the positions in `order` of
// the kept boxes to `keep`, at most max_keep of them, and returns their
// number. A candidate is suppressed iff a kept box before it in `order`
// has its bit, which is what nms_rotated's pair tests decide.
int nms_scan_rows(const uint64_t* rows, int words, const int64_t* order,
                  int n, int max_keep, int64_t* keep) {
  std::vector<uint64_t> removed(words, 0);
  int m = 0;
  for (int a = 0; a < n && m < max_keep; ++a) {
    const int64_t i = order[a];
    if ((removed[i >> 6] >> (i & 63)) & 1) continue;
    keep[m++] = a;
    const uint64_t* r = rows + i * words;
    for (int w = 0; w < words; ++w) removed[w] |= r[w];
  }
  return m;
}

}  // extern "C"
