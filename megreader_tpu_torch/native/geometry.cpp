// Native host geometry kernels for megreader_tpu.
//
// The reference leans on C++ through pyclipper (polygon offsetting) and
// OpenCV (connected components) — SURVEY.md §2.6 N5/N6. This is our own
// implementation of the three host-side geometry primitives the framework
// needs, exposed through a plain C ABI for ctypes:
//
//   mr_offset_polygon      edge-normal offset + adjacent-edge intersection
//                          (exact for convex polygons; pyclipper replacement
//                          for quad shrink/unclip)
//   mr_polygon_inter_area  convex clip (Sutherland–Hodgman) intersection area
//   mr_polygon_area        shoelace area
//   mr_connected_components two-pass union-find CCL (cv2 oracle replacement)
//   mr_batch_quad_iou      all-pairs IoU matrix for two quad sets (the
//                          detection measurer hot loop)
//
// Compute path stays JAX/XLA/Pallas on TPU; this is host runtime only
// (GT geometry at data-load time + eval metrics).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

double signed_area(const Pt* poly, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = poly[i];
    const Pt& q = poly[(i + 1) % n];
    a += p.x * q.y - q.x * p.y;
  }
  return 0.5 * a;
}

// Sutherland–Hodgman clip of `subject` by convex `clip` (made CCW here).
int clip_convex(const Pt* subject, int ns, const Pt* clip_in, int nc,
                Pt* out, int max_out) {
  std::vector<Pt> clip(clip_in, clip_in + nc);
  if (signed_area(clip.data(), nc) < 0.0) {
    for (int i = 0; i < nc / 2; ++i) std::swap(clip[i], clip[nc - 1 - i]);
  }
  std::vector<Pt> cur(subject, subject + ns), next;
  for (int e = 0; e < nc && !cur.empty(); ++e) {
    const Pt a = clip[e];
    const Pt b = clip[(e + 1) % nc];
    next.clear();
    Pt s = cur.back();
    auto inside = [&](const Pt& p) {
      return (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x) >= 0.0;
    };
    auto intersect = [&](const Pt& p1, const Pt& p2) {
      double dx1 = p2.x - p1.x, dy1 = p2.y - p1.y;
      double dx2 = b.x - a.x, dy2 = b.y - a.y;
      double denom = dx1 * dy2 - dy1 * dx2;
      if (std::fabs(denom) < 1e-12) return p2;
      double t = ((a.x - p1.x) * dy2 - (a.y - p1.y) * dx2) / denom;
      return Pt{p1.x + t * dx1, p1.y + t * dy1};
    };
    for (const Pt& p : cur) {
      bool pin = inside(p), sin_ = inside(s);
      if (pin) {
        if (!sin_) next.push_back(intersect(s, p));
        next.push_back(p);
      } else if (sin_) {
        next.push_back(intersect(s, p));
      }
      s = p;
    }
    cur.swap(next);
  }
  int n = (int)cur.size();
  if (n > max_out) n = max_out;
  std::memcpy(out, cur.data(), n * sizeof(Pt));
  return n;
}

struct DSU {
  std::vector<int32_t> parent;
  explicit DSU(int n) : parent(n) {
    for (int i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b < a ? a : b] = (b < a ? b : a);  // smaller root wins
  }
};

}  // namespace

extern "C" {

double mr_polygon_area(const double* xy, int n) {
  return std::fabs(signed_area(reinterpret_cast<const Pt*>(xy), n));
}

// Offset polygon by `dist` (positive = outward). Writes n output points.
// Returns 0 on success, -1 on degenerate input.
int mr_offset_polygon(const double* xy, int n, double dist, double* out_xy) {
  if (n < 3) return -1;
  const Pt* poly = reinterpret_cast<const Pt*>(xy);
  Pt* out = reinterpret_cast<Pt*>(out_xy);
  bool ccw = signed_area(poly, n) > 0.0;
  std::vector<Pt> sa(n), sb(n);
  for (int i = 0; i < n; ++i) {
    Pt a = poly[i], b = poly[(i + 1) % n];
    double ex = b.x - a.x, ey = b.y - a.y;
    double len = std::sqrt(ex * ex + ey * ey);
    double nx = 0.0, ny = 0.0;
    if (len > 1e-12) {
      nx = ey / len;  // outward normal for CCW
      ny = -ex / len;
      if (!ccw) { nx = -nx; ny = -ny; }
    }
    sa[i] = {a.x + nx * dist, a.y + ny * dist};
    sb[i] = {b.x + nx * dist, b.y + ny * dist};
  }
  for (int i = 0; i < n; ++i) {
    int prev = (i - 1 + n) % n;
    Pt p1 = sa[prev], p2 = sb[prev], p3 = sa[i], p4 = sb[i];
    double d1x = p2.x - p1.x, d1y = p2.y - p1.y;
    double d2x = p4.x - p3.x, d2y = p4.y - p3.y;
    double denom = d1x * d2y - d1y * d2x;
    if (std::fabs(denom) < 1e-12) {
      out[i] = p3;
    } else {
      double t = ((p3.x - p1.x) * d2y - (p3.y - p1.y) * d2x) / denom;
      out[i] = {p1.x + t * d1x, p1.y + t * d1y};
    }
  }
  return 0;
}

double mr_polygon_inter_area(const double* xy1, int n1, const double* xy2,
                             int n2) {
  if (n1 < 3 || n2 < 3) return 0.0;
  std::vector<Pt> buf(n1 + n2 + 8);
  int n = clip_convex(reinterpret_cast<const Pt*>(xy1), n1,
                      reinterpret_cast<const Pt*>(xy2), n2, buf.data(),
                      (int)buf.size());
  if (n < 3) return 0.0;
  return std::fabs(signed_area(buf.data(), n));
}

// All-pairs IoU of two quad sets: preds (np,4,2) gts (ng,4,2) -> out (np*ng).
void mr_batch_quad_iou(const double* preds, int np, const double* gts, int ng,
                       double* out) {
  for (int i = 0; i < np; ++i) {
    const double* p = preds + i * 8;
    double ap = mr_polygon_area(p, 4);
    for (int j = 0; j < ng; ++j) {
      const double* g = gts + j * 8;
      double ag = mr_polygon_area(g, 4);
      double inter = mr_polygon_inter_area(p, 4, g, 4);
      double uni = ap + ag - inter;
      out[i * ng + j] = uni > 0.0 ? inter / uni : 0.0;
    }
  }
}

// 4-connected CCL via union-find; labels: 0 background, 1..count components.
// Returns component count.
int mr_connected_components(const uint8_t* mask, int h, int w,
                            int32_t* labels) {
  const int n = h * w;
  DSU dsu(n);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int i = y * w + x;
      if (!mask[i]) continue;
      if (x > 0 && mask[i - 1]) dsu.unite(i, i - 1);
      if (y > 0 && mask[i - w]) dsu.unite(i, i - w);
    }
  }
  std::vector<int32_t> remap(n, 0);
  int32_t next_id = 0;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) {
      labels[i] = 0;
      continue;
    }
    int32_t root = dsu.find(i);
    if (remap[root] == 0) remap[root] = ++next_id;
    labels[i] = remap[root];
  }
  return next_id;
}

}  // extern "C"
